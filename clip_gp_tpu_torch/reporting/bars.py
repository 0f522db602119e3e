"""Cross-experiment grouped bar plots — the ``scripts/test.ipynb`` analog
(ref: scripts/test.ipynb, the one active cell).

The reference notebook reads an ad-hoc ``runs.csv`` (experiment_name,
dataset, shots, acc/ece/aece mean±std) and renders, per dataset, a 1×3
grouped-bar figure (Accuracy / ECE / AECE vs shots, one bar group per
experiment, legend on the AECE panel). This module produces the same
figures directly from on-disk ``metrics.json`` runs — no hand-maintained
CSV — and also writes the ``runs.csv`` the notebook consumed, for anyone
with existing notebook workflows. A copy of the JAX package's
``reporting/bars.py`` with its import paths changed; the figures need
matplotlib, the CSV does not.

Usage:
  python -m clip_gp_tpu_torch.reporting.bars exp1 exp2 --output-root output \\
      [--outdir output/plots]
"""

from __future__ import annotations

import argparse
import csv
import math
import statistics
from pathlib import Path
from typing import Any, Dict, List

from clip_gp_tpu_torch.reporting.aggregate import (
    _fmean,
    _pstdev,
    _run_metric,
    group_runs,
    load_runs,
    pyplot,
)

METRICS = (
    ("acc_mean", "acc_std", "Accuracy", "acc"),
    ("ece_mean", "ece_std", "ECE", "ece"),
    ("aece_mean", "aece_std", "AECE", "aece"),
)


def build_rows(output_root: Path, experiments: List[str]) -> List[Dict[str, Any]]:
    """runs.csv-shaped rows: one per (experiment, dataset, shots, config)."""
    rows = []
    for exp in experiments:
        grouped = group_runs(load_runs(Path(output_root) / exp))
        for dataset, shots_map in grouped.items():
            for shots, cfg_map in shots_map.items():
                for cfg, runs in cfg_map.items():
                    row: Dict[str, Any] = {
                        "experiment_name": exp,
                        "dataset": dataset,
                        "shots": int(shots),
                        "config_label": cfg,
                    }
                    for mean_key, std_key, _, metric in METRICS:
                        # same extraction + NaN tolerance and the same
                        # population stdev as the aggregate console tables,
                        # so runs.csv can never disagree with them
                        vals = [
                            v for r in runs
                            if not math.isnan(v := _run_metric(r, metric))
                        ]
                        row[mean_key] = _fmean(vals)
                        row[std_key] = _pstdev(vals)
                    rows.append(row)
    return rows


def write_runs_csv(rows: List[Dict[str, Any]], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fields = ["experiment_name", "dataset", "shots", "config_label"] + [
        k for m in METRICS for k in m[:2]
    ]
    with path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def make_bar_plots(rows: List[Dict[str, Any]], outdir: Path) -> List[Path]:
    import numpy as np

    plt = pyplot()

    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    datasets = sorted({r["dataset"] for r in rows})
    for dataset in datasets:
        g = [r for r in rows if r["dataset"] == dataset]
        models = sorted({r["experiment_name"] for r in g})
        shots = np.asarray(sorted({r["shots"] for r in g}))
        x = np.arange(len(shots))
        width = 0.8 / max(1, len(models))

        fig, axes = plt.subplots(1, 3, figsize=(20, 8), sharex=True)
        for ax, (mean_key, std_key, title, _) in zip(axes, METRICS):
            for i, model in enumerate(models):
                by_shots = {}
                for r in g:
                    if r["experiment_name"] == model:
                        by_shots.setdefault(r["shots"], []).append(r)
                y = np.asarray([
                    statistics.mean(r[mean_key] for r in by_shots[s])
                    if s in by_shots else np.nan
                    for s in shots
                ])
                yerr = np.asarray([
                    statistics.mean(r[std_key] for r in by_shots[s])
                    if s in by_shots else 0.0
                    for s in shots
                ])
                ax.bar(
                    x + (i - (len(models) - 1) / 2) * width, y, width,
                    yerr=yerr, capsize=3, edgecolor="black", linewidth=0.6,
                    label=model,
                )
            ax.set_title(title)
            ax.set_xlabel("Shots")
            ax.set_ylabel(title)
            ax.grid(True, ls="--", alpha=0.3, axis="y")
            ax.set_xticks(x, shots)
            if title == "Accuracy":
                vals = [r["acc_mean"] for r in g
                        if not math.isnan(r["acc_mean"])]
                if vals:
                    ax.set_ylim(max(0, min(vals) - 10), min(100, max(vals) + 10))
            if title == "AECE":
                ax.legend(frameon=False, loc="best")
        fig.tight_layout()
        path = outdir / f"{dataset}_all_metrics.png"
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("experiments", nargs="+")
    ap.add_argument("--output-root", default="output")
    ap.add_argument("--outdir", default=None,
                    help="default: <output-root>/plots")
    args = ap.parse_args(argv)
    output_root = Path(args.output_root)
    outdir = Path(args.outdir) if args.outdir else output_root / "plots"
    rows = build_rows(output_root, args.experiments)
    if not rows:
        print("no runs found")
        return 1
    write_runs_csv(rows, output_root / "runs.csv")
    written = make_bar_plots(rows, outdir)
    print(f"wrote {output_root / 'runs.csv'} and {len(written)} figure(s) "
          f"to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
