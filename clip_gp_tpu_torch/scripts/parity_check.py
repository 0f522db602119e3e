"""Real-weight parity harness: run the BASELINE.md parity configs and diff
top-1 / ECE / AECE against reference-run metrics.json artifacts (±0.3
percentage points — the BASELINE.md bar), as the JAX package's
``scripts/parity_check.py`` does, through the port's ``train.main``.

Usage:
  # one-time checkpoint conversion (an OpenAI .pt → the npz both packages
  # load):
  python -m clip_gp_tpu_torch.scripts.parity_check --convert /path/RN50.pt \\
      --weights-out ~/.cache/clip_gp_tpu/RN50.npz

  # run parity config #2 (Caltech101 4-shot RN50 GP) and diff:
  python -m clip_gp_tpu_torch.scripts.parity_check --config 2 --root /data \\
      --reference-root /path/to/reference_runs --output-root /tmp/parity

Reference artifacts are expected at
``<reference-root>/<trial_name>/metrics.json`` — the metrics.json each
reference run writes itself (ref: utils/trainer.py:599-639). Trials without
a reference artifact are reported NO-REF and don't fail the check. Trials
run on the GPU; ``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` runs them on the CPU.

Parity configs (BASELINE.md):
  1. Caltech101 4-shot RN50 baseline Adapter
  2. Caltech101 4-shot RN50 GP template weighter (RBF, 8 templates, MC)
  3. OxfordPets + DTD + EuroSAT 4-shot: CLIP-Adapter, TaskRes, Tip-Adapter-F
  4. CoOp + CoCoOp ViT-B/16 4-shot (Caltech101 representative)
  5. ImageNet 16-shot + OOD eval (V2/A/R/Sketch)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

TOLERANCE_PP = 0.3  # percentage points, BASELINE.md bar
METRIC_KEYS = ("top1_acc", "ece", "aece")


def _trial(name, dataset, trainer, shots, backbone, opts=(),
           eval_only_from=None):
    return {
        "name": name,
        "dataset": dataset,
        "trainer": trainer,
        "shots": shots,
        "backbone": backbone,
        "opts": list(opts),
        # name of an earlier trial whose saved adapter this one evaluates
        # (the reference OOD flow: --eval-only --model-dir, train.py:92-96)
        "eval_only_from": eval_only_from,
    }


def parity_trials(config_id: int, backbone_override=None):
    rn50 = backbone_override or "RN50"
    vit = backbone_override or "ViT-B/16"
    gp_opts = (
        "TRAINER.ADAPTER.USE_GP", "True",
        "TRAINER.ADAPTER.GP_KERNEL_TYPE", "rbf",
        "TRAINER.ADAPTER.NUM_TEMPLATES", "8",
    )
    if config_id == 1:
        return [_trial("caltech101_4shot_rn50_baseline",
                       "Caltech101", "Adapter", 4, rn50)]
    if config_id == 2:
        return [_trial("caltech101_4shot_rn50_gp",
                       "Caltech101", "Adapter", 4, rn50, gp_opts)]
    if config_id == 3:
        out = []
        for ds in ("OxfordPets", "DescribableTextures", "EuroSAT"):
            for trainer, tag in (("CLIP-Adapter", "clip_adapter"),
                                 ("TaskRes", "taskres"),
                                 ("Tip-Adapter", "tipaf")):
                opts = ()
                if trainer == "Tip-Adapter":
                    opts = ("TRAINER.ADAPTER.TIP_ADAPTER_TRAINABLE", "True",
                            "TRAINER.ADAPTER.TIP_ADAPTER_INIT_BETA", "1.0",
                            "TRAINER.ADAPTER.TIP_ADAPTER_INIT_ALPHA", "1.0")
                out.append(_trial(f"{ds.lower()}_4shot_{tag}",
                                  ds, trainer, 4, rn50, opts))
        return out
    if config_id == 4:
        return [
            _trial("caltech101_4shot_vitb16_coop",
                   "Caltech101", "Adapter-CoOp", 4, vit),
            _trial("caltech101_4shot_vitb16_cocoop",
                   "Caltech101", "Adapter-CoCoOp", 4, vit),
        ]
    if config_id == 5:
        out = [_trial(
            "imagenet_16shot_vitb16_gp", "ImageNet", "Adapter", 16, vit,
            gp_opts + ("TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True"),
        )]
        for ood in ("ImageNetV2", "ImageNetA", "ImageNetR", "ImageNetSketch"):
            out.append(_trial(
                f"{ood.lower()}_eval", ood, "Adapter", 1, vit, gp_opts,
                eval_only_from="imagenet_16shot_vitb16_gp",
            ))
        return out
    raise SystemExit(f"unknown parity config {config_id} (1..5)")


def run_trial(trial, root, output_root, seed, extra_opts=()):
    from clip_gp_tpu_torch import train as train_main
    from clip_gp_tpu_torch.core.logging import reset_tee

    out_dir = Path(output_root) / trial["name"]
    argv = [
        "--dataset", trial["dataset"],
        "--trainer", trial["trainer"],
        "--root", str(root),
        "--shots", str(trial["shots"]),
        "--backbone", trial["backbone"],
        "--seed", str(seed),
        "--output-dir", str(out_dir),
    ]
    if trial.get("eval_only_from"):
        model_dir = Path(output_root) / trial["eval_only_from"]
        argv += ["--eval-only", "--model-dir", str(model_dir)]
    argv += trial["opts"] + list(extra_opts)
    try:
        train_main.main(argv)
    finally:
        reset_tee()  # undo the trial's stdout/stderr log.txt redirect
    return json.loads((out_dir / "metrics.json").read_text())


def diff_metrics(run_metrics: dict, ref_metrics: dict,
                 tolerance_pp: float = TOLERANCE_PP):
    """Compare the metric block key-by-key; returns (ok, rows)."""
    rows = []
    ok = True
    for key in METRIC_KEYS:
        got = run_metrics["metrics"].get(key)
        want = ref_metrics["metrics"].get(key)
        if got is None or want is None:
            rows.append((key, got, want, None, "MISSING"))
            ok = False
            continue
        delta = abs(float(got) - float(want))
        passed = delta <= tolerance_pp
        ok = ok and passed
        rows.append((key, float(got), float(want), delta,
                     "OK" if passed else "FAIL"))
    return ok, rows


def convert(checkpoint: str, weights_out=None) -> str:
    """An OpenAI ``.pt`` checkpoint → the npz of the same keys and arrays
    the JAX package writes; returns its path. The conversion is host work
    (the BatchNorm fold in numpy), so the model stays on the CPU."""
    from clip_gp_tpu_torch.models.clip_loader import (
        load_torch_checkpoint,
        save_params_npz,
    )

    arch, model = load_torch_checkpoint(checkpoint, device="cpu")
    out = weights_out or (Path(checkpoint).stem + ".npz")
    save_params_npz(out, arch, model)
    print(f"converted {checkpoint} ({arch.name}) -> {out}")
    return out


def run(config: int, root: str = "data", reference_root=None,
        output_root: str = "output/parity", seed: int = 1,
        tolerance: float = TOLERANCE_PP, backbone_override=None,
        opts=()) -> dict:
    """Run parity config ``config`` and diff each trial against its
    reference artifact: ``{"trials": [(name, status, rows)], ...}``."""
    from clip_gp_tpu_torch.core.device import device_label

    trials = parity_trials(config, backbone_override)
    n_fail = n_noref = 0
    all_rows = []
    for trial in trials:
        result = run_trial(trial, root, output_root, seed, opts)
        ref_path = (
            Path(reference_root) / trial["name"] / "metrics.json"
            if reference_root else None
        )
        if ref_path is None or not ref_path.exists():
            n_noref += 1
            all_rows.append((trial["name"], "NO-REF", []))
            continue
        ref = json.loads(ref_path.read_text())
        ok, rows = diff_metrics(result, ref, tolerance)
        if not ok:
            n_fail += 1
        all_rows.append((trial["name"], "OK" if ok else "FAIL", rows))
    return {"metric": "parity", "config": config, "tolerance_pp": tolerance,
            "trials": all_rows, "n_fail": n_fail, "n_noref": n_noref,
            "device": device_label()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--convert", metavar="CKPT_PT",
                    help="convert an OpenAI .pt checkpoint to npz and exit")
    ap.add_argument("--weights-out", default=None,
                    help="npz output path for --convert")
    ap.add_argument("--config", type=int, choices=range(1, 6),
                    help="BASELINE parity config id (1..5)")
    ap.add_argument("--root", default="data", help="dataset root")
    ap.add_argument("--reference-root", default=None,
                    help="directory of reference-run artifacts "
                         "(<name>/metrics.json per trial)")
    ap.add_argument("--output-root", default="output/parity")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tolerance", type=float, default=TOLERANCE_PP,
                    help="max |delta| in percentage points (default 0.3)")
    ap.add_argument("--backbone-override", default=None,
                    help="e.g. TEST-ViT for checkpoint-free smoke runs")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="extra OPTS forwarded to every trial")
    args = ap.parse_args(argv)

    if args.convert:
        convert(args.convert, args.weights_out)
        return 0
    if not args.config:
        ap.error("--config or --convert required")

    report = run(args.config, args.root, args.reference_root, args.output_root,
                 args.seed, args.tolerance, args.backbone_override, args.opts)
    all_rows = report["trials"]
    print(f"\n=== parity config #{args.config} "
          f"(tolerance ±{args.tolerance} pp) ===")
    for name, status, rows in all_rows:
        print(f"[{status}] {name}")
        for key, got, want, delta, row_status in rows:
            d = f"{delta:.3f}" if delta is not None else "n/a"
            print(f"    {key:>9}: run={got} ref={want} |d|={d} {row_status}")
    print(f"{len(all_rows)} trial(s): "
          f"{len(all_rows) - report['n_fail'] - report['n_noref']} ok, "
          f"{report['n_fail']} fail, {report['n_noref']} without reference "
          "artifact")
    print(json.dumps(report))
    return 1 if report["n_fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
