"""Results aggregation: summaries, plots, CSV tables
(ref: scripts/aggregate_results.py), a copy of the JAX package's
``reporting/aggregate.py`` with its import paths changed. It needs the
stdlib only: matplotlib is imported where a plot is asked for
(``pyplot``), and ``--no-plots`` prints the tables and writes the CSVs
without it.

Run as ``python -m clip_gp_tpu_torch.reporting.aggregate <experiment>
--output-root <root>``.

Input layout contract: ``output/<experiment>/<dataset>/<config>/seed*/
metrics.json`` with the reference schema. Outputs:
- per-dataset and cross-dataset mean±std console tables (zero-shot rows
  synthesized from 1-shot runs' ``zero_shot`` block);
- Accuracy/ECE/AECE-vs-shots plots per dataset + average →
  ``_plots/perf_per_shots/``; Accuracy-vs-ECE curves → ``_plots/acc_vs_ece/``;
- per-dataset + Average CSVs with ``acc_{s}``/``ece_{s}`` columns →
  ``_tables/``;
- ``--delete`` prunes seed dirs missing metrics.json; ``--grouped`` merges
  config families by substring.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import statistics
from pathlib import Path
from typing import Any, Dict, List


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported only where a plot
    is asked for, so tables and CSVs need the stdlib alone. Without
    matplotlib a plot request raises; ``--no-plots`` asks for none."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "the plots need matplotlib, which is not installed; pass "
            "--no-plots for the tables and CSVs alone"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

GROUP_SUBSTRINGS: Dict[str, str] = {
    "_1template": "1 Template",
    "_8templates": "8 Templates",
    "_88templates": "88 Templates",
    "_custom_templates": "Custom Templates",
}

METRICS = ("acc", "ece", "aece")


def _fmean(vals: List[float]) -> float:
    return statistics.fmean(vals) if vals else float("nan")


def _pstdev(vals: List[float]) -> float:
    return statistics.pstdev(vals) if len(vals) > 1 else 0.0


def _run_metric(r: Dict[str, Any], name: str) -> float:
    m = r.get("metrics", {})
    if name == "acc":
        v = m.get("accuracy", m.get("top1_acc", float("nan")))
    else:
        v = m.get(name, float("nan"))
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _zero_shot_values(runs: List[Dict[str, Any]], key: str) -> List[float]:
    out = []
    for r in runs:
        zs = r.get("zero_shot")
        if isinstance(zs, dict):
            try:
                v = float(zs.get(key))
            except (TypeError, ValueError):
                continue
            if not math.isnan(v):
                out.append(v)
    return out


def load_runs(exp_dir: Path, delete: bool = False) -> List[Dict[str, Any]]:
    runs = []
    if not exp_dir.is_dir():
        return runs
    for dataset_dir in sorted(d for d in exp_dir.iterdir() if d.is_dir()):
        if dataset_dir.name.startswith("_"):
            continue
        for config_dir in sorted(d for d in dataset_dir.iterdir() if d.is_dir()):
            for seed_dir in sorted(config_dir.glob("seed*")):
                metrics_path = seed_dir / "metrics.json"
                if not metrics_path.is_file():
                    if delete:
                        import shutil

                        shutil.rmtree(seed_dir)
                    else:
                        print(f"Skipping {seed_dir} because it doesn't exist")
                    continue
                try:
                    payload = json.loads(metrics_path.read_text())
                except Exception:
                    continue
                payload["_dataset_dir"] = dataset_dir.name
                payload["_config_label"] = config_dir.name
                payload["_seed_dir"] = seed_dir.name
                runs.append(payload)
    return runs


def group_runs(runs: List[Dict[str, Any]]):
    grouped: Dict[str, Dict[int, Dict[str, List[Dict[str, Any]]]]] = {}
    for r in runs:
        ds = r.get("dataset") or r.get("_dataset_dir")
        shots = int(r.get("shots", 0))
        cfg = r.get("_config_label", "config")
        grouped.setdefault(ds, {}).setdefault(shots, {}).setdefault(cfg, []).append(r)
    return grouped


def _rows_for_dataset(shots_map) -> List[tuple]:
    rows = []
    for shots, cfg_map in sorted(shots_map.items()):
        for cfg, rs in sorted(cfg_map.items()):
            stats = []
            for metric in METRICS:
                vals = [
                    v for v in (_run_metric(r, metric) for r in rs)
                    if not math.isnan(v)
                ]
                stats += [_fmean(vals), _pstdev(vals)]
            rows.append((cfg, shots, len(rs), *stats))
    if 1 in shots_map:  # zero-shot rows from the 1-shot runs
        for cfg, rs in sorted(shots_map[1].items()):
            stats = []
            for key in ("top1_acc", "ece", "aece"):
                vals = _zero_shot_values(rs, key)
                stats += [_fmean(vals), _pstdev(vals)]
            rows.append((cfg.replace("_1shots", "_0shots"), 0, len(rs), *stats))
    rows.sort(key=lambda x: (x[1], x[0]))
    return rows


def print_summary(grouped) -> None:
    for ds, shots_map in grouped.items():
        print(f"\n=== Dataset: {ds} ===")
        rows = _rows_for_dataset(shots_map)
        width = max([len(r[0]) for r in rows] + [6])
        print(
            f"{'Config':<{width}} {'Shots':>5} {'Seeds':>5} | {'Acc µ':>7} "
            f"{'Acc σ':>7} | {'ECE µ':>7} {'ECE σ':>7} | {'AECE µ':>7} {'AECE σ':>7}"
        )
        print("-" * (width + 66))
        for cfg, shots, n, am, asd, em, esd, aem, aesd in rows:
            print(
                f"{cfg:<{width}} {shots:>5d} {n:>5d} | {am:7.2f} {asd:7.2f} | "
                f"{em:7.3f} {esd:7.3f} | {aem:7.3f} {aesd:7.3f}"
            )


def per_dataset_fam_means(grouped):
    """ds → fam → shots → {acc, ece, aece} (seed means; fam strips the
    _<shots>shots suffix; shot 0 = zero-shot from 1-shot runs)."""
    per_ds: Dict[str, Dict[str, Dict[int, Dict[str, float]]]] = {}
    for ds, shots_map in grouped.items():
        per_cfg: Dict[str, Dict[int, Dict[str, float]]] = {}
        for shots, cfg_map in shots_map.items():
            for cfg, rs in cfg_map.items():
                fam = cfg.replace(f"_{shots}shots", "")
                per_cfg.setdefault(fam, {})[shots] = {
                    metric: _fmean(
                        [
                            v
                            for v in (_run_metric(r, metric) for r in rs)
                            if not math.isnan(v)
                        ]
                    )
                    for metric in METRICS
                }
        if 1 in shots_map:
            for cfg, rs in shots_map[1].items():
                fam = cfg.replace("_1shots", "")
                per_cfg.setdefault(fam, {})[0] = {
                    "acc": _fmean(_zero_shot_values(rs, "top1_acc")),
                    "ece": _fmean(_zero_shot_values(rs, "ece")),
                    "aece": _fmean(_zero_shot_values(rs, "aece")),
                }
        per_ds[ds] = per_cfg
    return per_ds


def collect_across_datasets(
    per_ds,
) -> Dict[str, Dict[int, Dict[str, List[float]]]]:
    """fam -> shots -> metric -> per-dataset values (NaNs dropped) — the one
    cross-dataset aggregation used by the console Average table, the Average
    plots, and Average.csv (they must not drift apart)."""
    agg: Dict[str, Dict[int, Dict[str, List[float]]]] = {}
    for fam_map in per_ds.values():
        for fam, shot_map in fam_map.items():
            for shots, metrics in shot_map.items():
                lists = agg.setdefault(fam, {}).setdefault(
                    shots, {m: [] for m in METRICS}
                )
                for m in METRICS:
                    if not math.isnan(metrics[m]):
                        lists[m].append(metrics[m])
    return agg


def average_across_datasets(per_ds):
    """fam -> shots -> metric -> mean over datasets."""
    return {
        fam: {
            s: {m: _fmean(lists[m]) for m in METRICS}
            for s, lists in shot_map.items()
        }
        for fam, shot_map in collect_across_datasets(per_ds).items()
    }


def print_average_summary(grouped) -> None:
    per_ds = per_dataset_fam_means(grouped)
    agg = collect_across_datasets(per_ds)
    rows = []
    for fam, shot_map in agg.items():
        for shots, lists in shot_map.items():
            stats = []
            for m in METRICS:
                stats += [_fmean(lists[m]), _pstdev(lists[m])]
            n_ds = max(len(lists[m]) for m in METRICS)
            rows.append((f"{fam}_{shots}shots", shots, n_ds, *stats))
    if not rows:
        return
    rows.sort(key=lambda x: (x[1], x[0]))
    width = max(len(r[0]) for r in rows)
    print(f"\n=== Average across datasets ({len(grouped)} datasets) ===")
    print(
        f"{'Config':<{width}} {'Shots':>5} {'Datasets':>9} | {'Acc µ':>7} "
        f"{'Acc σ':>7} | {'ECE µ':>7} {'ECE σ':>7} | {'AECE µ':>7} {'AECE σ':>7}"
    )
    print("-" * (width + 70))
    for cfg, shots, n_ds, am, asd, em, esd, aem, aesd in rows:
        print(
            f"{cfg:<{width}} {shots:>5d} {n_ds:>9d} | {am:7.2f} {asd:7.2f} | "
            f"{em:7.3f} {esd:7.3f} | {aem:7.3f} {aesd:7.3f}"
        )


def group_fams(per_cfg):
    """Merge config families by GROUP_SUBSTRINGS (first match wins)."""
    assigned = set()
    out: Dict[str, Dict[int, Dict[str, float]]] = {}
    for sub, label in GROUP_SUBSTRINGS.items():
        matched = [fam for fam in per_cfg if fam not in assigned and sub in fam]
        if not matched:
            continue
        shots_all = sorted({s for fam in matched for s in per_cfg[fam]})
        shot_map = {}
        for s in shots_all:
            shot_map[s] = {
                m: _fmean(
                    [
                        per_cfg[fam][s][m]
                        for fam in matched
                        if s in per_cfg[fam] and not math.isnan(per_cfg[fam][s][m])
                    ]
                )
                for m in METRICS
            }
        out[f"{label} ({len(matched)})"] = shot_map
        assigned.update(matched)
    for fam in per_cfg:
        if fam not in assigned:
            out[fam] = per_cfg[fam]
    return out


def group_fams_ref(per_cfg):
    """Reference-exact grouping for one dataset
    (ref: scripts/aggregate_results.py:228-261): returns
    (plot map with "<label> (N)" keys, collect map with clean keys,
    label → matched fam set). Unlike :func:`group_fams`, fams matching no
    GROUP_SUBSTRINGS entry are DROPPED (the reference never plots them
    under --grouped)."""
    assigned = set()
    plot_map: Dict[str, Dict[int, Dict[str, float]]] = {}
    collect_map: Dict[str, Dict[int, Dict[str, float]]] = {}
    group_to_fams: Dict[str, set] = {}
    for sub, label in GROUP_SUBSTRINGS.items():
        matched = [fam for fam in per_cfg if fam not in assigned and sub in fam]
        if not matched:
            continue
        shots_all = sorted({s for fam in matched for s in per_cfg[fam]})
        shot_map = {
            s: {
                m: _fmean(
                    [
                        per_cfg[fam][s][m]
                        for fam in matched
                        if s in per_cfg[fam]
                        and not math.isnan(per_cfg[fam][s][m])
                    ]
                )
                for m in METRICS
            }
            for s in shots_all
        }
        plot_map[f"{label} ({len(matched)})"] = shot_map
        collect_map[label] = shot_map
        group_to_fams.setdefault(label, set()).update(matched)
        assigned.update(matched)
    return plot_map, collect_map, group_to_fams


def _ref_grouped_average(per_ds):
    """Reference --grouped averaging order (ref:
    scripts/aggregate_results.py:346-386): group WITHIN each dataset first,
    then average each group label's per-dataset values. Returns
    (per-dataset plot maps, Average map labeled "<label> (N configs)")."""
    grouped_ds: Dict[str, Dict[str, Dict[int, Dict[str, float]]]] = {}
    collect: Dict[str, Dict[int, Dict[str, List[float]]]] = {}
    all_fams: Dict[str, set] = {}
    for ds, fam_map in per_ds.items():
        plot_map, collect_map, g2f = group_fams_ref(fam_map)
        grouped_ds[ds] = plot_map
        for label, shot_map in collect_map.items():
            for s, met in shot_map.items():
                lists = collect.setdefault(label, {}).setdefault(
                    s, {m: [] for m in METRICS}
                )
                for m in METRICS:
                    if not math.isnan(met[m]):
                        lists[m].append(met[m])
        for label, fams in g2f.items():
            all_fams.setdefault(label, set()).update(fams)
    avg = {
        f"{label} ({len(all_fams[label])} configs)": {
            s: {m: _fmean(lists[m]) for m in METRICS}
            for s, lists in shot_maps.items()
        }
        for label, shot_maps in collect.items()
    }
    return grouped_ds, avg


def make_plots(
    grouped,
    exp_name: str,
    output_root: Path = Path("output"),
    use_grouping: bool = False,
    show_zero_shot: bool = False,
    ref_style: bool = False,
) -> None:
    """``ref_style`` reproduces the reference's plotted DATA SERIES exactly
    (golden-pinned vs the executed reference,
    tests/test_reference_executed_plots.py) where the default style
    deliberately diverges: acc-vs-ECE points sort by ECE with an
    average-position star per config (ref: scripts/aggregate_results.py:
    482-540), the shots axis is linear with explicit ticks (ref: :452),
    and --grouped averages group-within-dataset-first, dropping ungrouped
    fams (ref: :228-261, :346-386). Default style: shot-ordered acc-vs-ECE
    lines, symlog shots axis, group-after-average keeping ungrouped fams."""
    plt = pyplot()

    plots_dir = output_root / exp_name / "_plots"
    pps_dir = plots_dir / "perf_per_shots"
    ave_dir = plots_dir / "acc_vs_ece"
    pps_dir.mkdir(parents=True, exist_ok=True)
    ave_dir.mkdir(parents=True, exist_ok=True)
    per_ds = dict(per_dataset_fam_means(grouped))
    pre_grouped = False
    if ref_style and use_grouping:
        per_ds, avg = _ref_grouped_average(per_ds)
        per_ds["Average"] = avg
        pre_grouped = True
    else:
        # average pseudo-dataset
        per_ds["Average"] = average_across_datasets(per_ds)

    for ds, fam_map in per_ds.items():
        if use_grouping and not pre_grouped:
            fam_map = group_fams(fam_map)
        # perf vs shots: one subplot per metric
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        all_shots = sorted({s for sm in fam_map.values() for s in sm})
        for ax, metric, title in zip(
            axes, METRICS, ("Accuracy (%)", "ECE (%)", "AECE (%)")
        ):
            for fam, shot_map in sorted(fam_map.items()):
                # the line connects s>0 only; the zero-shot point is drawn
                # as a star, never a line vertex
                # (ref: scripts/aggregate_results.py:432)
                shots = sorted(s for s in shot_map if s > 0)
                xs = [s for s in shots if not math.isnan(shot_map[s][metric])]
                ys = [shot_map[s][metric] for s in xs]
                if not xs:
                    continue
                (line,) = ax.plot(xs, ys, marker="o", label=fam)
                if show_zero_shot and 0 in shot_map:
                    # star must reuse the line's color — a bare scatter would
                    # consume the NEXT color-cycle entry and render every
                    # family's zero-shot point in a different family's color
                    # (ref: scripts/aggregate_results.py:462-467)
                    ax.scatter([0], [shot_map[0][metric]], marker="*", s=120,
                               color=line.get_color())
            ax.set_xlabel("shots")
            ax.set_title(f"{ds}: {title}")
            if ref_style:
                # linear axis, one tick per shot count (ref: :452)
                ax.set_xticks(
                    sorted(set(s for s in all_shots if s > 0)
                           | ({0} if show_zero_shot else set()))
                )
            else:
                ax.set_xscale("symlog", base=2)
            ax.grid(alpha=0.3)
        axes[0].legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(pps_dir / f"{ds}.png", dpi=120)
        plt.close(fig)

        # acc vs ece
        fig, ax = plt.subplots(figsize=(6, 5))
        for fam, shot_map in sorted(fam_map.items()):
            pts = [
                (shot_map[s]["ece"], shot_map[s]["acc"])
                for s in sorted(shot_map)
                if s > 0
                and not math.isnan(shot_map[s]["ece"])
                and not math.isnan(shot_map[s]["acc"])
            ]
            if not pts:
                continue
            if ref_style:
                # points sort by ECE, not shots (ref: :502)
                pts.sort(key=lambda p: p[0])
            (line,) = ax.plot(*zip(*pts), marker="o", label=fam)
            if ref_style:
                # star at the config's average (ECE, acc) position
                # (ref: :512-516)
                ax.scatter(
                    [_fmean([p[0] for p in pts])],
                    [_fmean([p[1] for p in pts])],
                    marker="*", s=200, color=line.get_color(), zorder=10,
                )
            if show_zero_shot and 0 in shot_map:
                ax.scatter(
                    [shot_map[0]["ece"]], [shot_map[0]["acc"]],
                    marker="*", s=150, color=line.get_color(),
                )
        ax.set_xlabel("ECE (%)")
        ax.set_ylabel("Accuracy (%)")
        ax.set_title(ds)
        ax.grid(alpha=0.3)
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(ave_dir / f"{ds}.png", dpi=120)
        plt.close(fig)


def make_reliability_diagrams(
    grouped, exp_name: str, output_root: Path = Path("output")
) -> None:
    """Reliability diagrams from the per-bin calibration arrays in
    metrics.json (the reference records the arrays but never plots them)."""
    plt = pyplot()

    out_dir = output_root / exp_name / "_plots" / "reliability"
    out_dir.mkdir(parents=True, exist_ok=True)
    for ds, shots_map in grouped.items():
        for shots, cfg_map in shots_map.items():
            for cfg, rs in cfg_map.items():
                calib = next(
                    (
                        c
                        for r in rs
                        if (c := r.get("metrics", {}).get("calibration"))
                        and c.get("bin_count")
                    ),
                    None,
                )
                if calib is None:
                    continue
                # average bins across seeds, count-weighted
                n_bins = len(calib["bin_acc"])
                acc = [0.0] * n_bins
                conf = [0.0] * n_bins
                cnt = [0.0] * n_bins
                for r in rs:
                    c = r.get("metrics", {}).get("calibration") or {}
                    if len(c.get("bin_acc", [])) != n_bins:
                        continue
                    for i in range(n_bins):
                        w = c["bin_count"][i]
                        acc[i] += c["bin_acc"][i] * w
                        conf[i] += c["bin_conf"][i] * w
                        cnt[i] += w
                acc = [a / c if c else 0.0 for a, c in zip(acc, cnt)]
                conf = [f / c if c else (i + 0.5) / n_bins
                        for i, (f, c) in enumerate(zip(conf, cnt))]
                fig, ax = plt.subplots(figsize=(4.5, 4.5))
                centers = [(i + 0.5) / n_bins for i in range(n_bins)]
                ax.bar(centers, acc, width=1.0 / n_bins * 0.9,
                       label="accuracy", alpha=0.8)
                ax.plot([0, 1], [0, 1], "k--", lw=1, label="perfect")
                # empty bins carry no samples — plotting their placeholder
                # (center, 0) would look like a catastrophically
                # miscalibrated bin
                pts = [(f, a) for f, a, c in zip(conf, acc, cnt) if c]
                if pts:
                    ax.scatter(*zip(*pts), color="C3", s=14, zorder=3,
                               label="avg confidence")
                # same NaN filter as the console tables: one seed missing
                # 'ece' must not poison the title
                eces = [e for r in rs
                        if not math.isnan(e := _run_metric(r, "ece"))]
                ece_txt = f"ECE {_fmean(eces):.2f}%" if eces else "ECE n/a"
                ax.set_xlabel("confidence")
                ax.set_ylabel("accuracy")
                ax.set_title(f"{ds} / {cfg} ({ece_txt})", fontsize=9)
                ax.set_xlim(0, 1)
                ax.set_ylim(0, 1)
                ax.legend(fontsize=7)
                fig.tight_layout()
                # shots in the filename: a config dir named without the
                # shots suffix would otherwise overwrite its own PNG once
                # per shot count
                fig.savefig(out_dir / f"{ds}__{cfg}__{shots}shots.png",
                            dpi=110)
                plt.close(fig)


def write_experiment_tables(
    grouped, exp_name: str, output_root: Path = Path("output"), shots_set=None
) -> None:
    shots_set = shots_set or [1, 2, 4, 8, 16, 32]
    out_dir = output_root / exp_name / "_tables"
    out_dir.mkdir(parents=True, exist_ok=True)
    per_ds = per_dataset_fam_means(grouped)

    def write_csv(path: Path, fam_map):
        header = (
            ["method"]
            + [f"acc_{s}" for s in shots_set]
            + [f"ece_{s}" for s in shots_set]
        )
        with path.open("w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            for fam in sorted(fam_map):
                row = [fam]
                for metric in ("acc", "ece"):
                    for s in shots_set:
                        v = fam_map[fam].get(s, {}).get(metric, float("nan"))
                        row.append(f"{v:.2f}" if not math.isnan(v) else "")
                writer.writerow(row)

    for ds, fam_map in per_ds.items():
        write_csv(out_dir / f"{ds}.csv", fam_map)
    # average across datasets
    write_csv(out_dir / "Average.csv", average_across_datasets(per_ds))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Aggregate metrics.json runs")
    ap.add_argument("experiment")
    ap.add_argument("--output-root", default="output")
    ap.add_argument("--delete", action="store_true")
    ap.add_argument("--grouped", action="store_true")
    ap.add_argument("--show-zero-shot", action="store_true")
    ap.add_argument(
        "--ref-style", action="store_true",
        help="plot the reference's exact data series for honest A/B figure "
             "comparison: ECE-sorted acc-vs-ECE lines with average-position "
             "stars, linear shots axis, group-within-dataset-first --grouped "
             "averaging (drops ungrouped config families, like the "
             "reference)",
    )
    ap.add_argument(
        "--no-plots", action="store_true",
        help="print the tables and write the CSVs only (no matplotlib)",
    )
    args = ap.parse_args(argv)
    output_root = Path(args.output_root)
    runs = load_runs(output_root / args.experiment, args.delete)
    if not runs:
        print("No metrics.json found. Did the runs finish?")
        return
    grouped = group_runs(runs)
    print_summary(grouped)
    print_average_summary(grouped)
    if not args.no_plots:
        make_plots(
            grouped,
            args.experiment,
            output_root,
            use_grouping=args.grouped,
            show_zero_shot=args.show_zero_shot,
            ref_style=args.ref_style,
        )
        make_reliability_diagrams(grouped, args.experiment, output_root)
    write_experiment_tables(grouped, args.experiment, output_root)


if __name__ == "__main__":
    main()
