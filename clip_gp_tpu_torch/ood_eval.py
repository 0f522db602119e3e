"""OOD robustness evaluation: one ImageNet-trained run on every OOD variant.

The counterpart of the JAX package's ``scripts/ood_eval.py`` (BASELINE
config #5). It reloads the run's ``config.json`` and evaluates each
requested variant, with the per-class state row-remapped by wnid where the
variant keeps a class subset (ImageNet-A and -R keep 200 classes), then
writes each variant's metrics.json under ``<model-dir>/ood/<variant>/`` and
an ``ood_metrics.json`` summary with the JAX script's keys.

Usage (on the GPU; ``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` runs it on the CPU):

  python -m clip_gp_tpu_torch.ood_eval --model-dir output/imagenet/gp/seed1 \\
      --root /data [--variants ImageNetV2,ImageNetSketch,ImageNetA,ImageNetR]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

DEFAULT_VARIANTS = ("ImageNetV2", "ImageNetSketch", "ImageNetA", "ImageNetR")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True,
                    help="trained run output dir (config.json + adapter/)")
    ap.add_argument("--root", default=None,
                    help="dataset root containing the OOD variant dirs "
                         "(default: the run's DATASET.ROOT)")
    ap.add_argument("--variants", default=",".join(DEFAULT_VARIANTS),
                    help="comma-separated dataset names to evaluate")
    ap.add_argument("--output", default=None,
                    help="summary JSON (default <model-dir>/ood_metrics.json)")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--load-epoch", type=int, default=None)
    args = ap.parse_args(argv)

    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401
    from clip_gp_tpu_torch.core.config import config_from_dict
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager

    model_dir = Path(args.model_dir)
    cfg_path = model_dir / "config.json"
    if not cfg_path.exists():
        raise SystemExit(f"missing {cfg_path} — not a run directory?")
    with cfg_path.open() as f:
        base_cfg_dict = json.load(f)

    summary = {
        "model_dir": str(model_dir),
        "source_dataset": base_cfg_dict.get("dataset", {}).get("name"),
        "variants": {},
    }
    failures = 0
    for name in [v.strip() for v in args.variants.split(",") if v.strip()]:
        config = config_from_dict(json.loads(json.dumps(base_cfg_dict)))
        config.dataset.name = name
        # OOD variants are full test sets of the source task: never few-shot
        # sampled, never subsampled
        config.dataset.num_shots = -1
        config.dataset.subsample_classes = "all"
        if args.root:
            config.dataset.root = args.root
        if args.batch_size:
            config.dataloader.batch_size_test = args.batch_size
        config.output_dir = str(model_dir / "ood" / name)
        print(f"\n=== {name} ===")
        try:
            set_random_seed(max(int(config.seed), 0))
            dm = build_data_manager(config)
            trainer = build_trainer(config, dm)
            trainer.build_model()
            if trainer.load_model(str(model_dir), epoch=args.load_epoch) == 0:
                raise RuntimeError("checkpoint reload failed")
            trainer.time_start = time.time()
            trainer.test()
            with (Path(config.output_dir) / "metrics.json").open() as f:
                m = json.load(f)["metrics"]
            summary["variants"][name] = {
                "top1_acc": m["top1_acc"],
                "macro_f1": m.get("macro_f1"),
                "ece": m["ece"],
                "aece": m["aece"],
                "num_classes": dm.num_classes,
                "num_images": len(dm.dataset.test),
            }
        except Exception as e:  # keep evaluating the remaining variants
            failures += 1
            print(f"[ood-eval] {name} FAILED: {e}")
            summary["variants"][name] = {"error": str(e)}

    out = Path(args.output) if args.output else model_dir / "ood_metrics.json"
    with out.open("w") as f:
        json.dump(summary, f, indent=2)

    print(f"\n{'variant':<18} {'top1':>7} {'ECE':>7} {'AECE':>7} {'K':>6} {'N':>7}")
    for name, row in summary["variants"].items():
        if "error" in row:
            print(f"{name:<18} ERROR: {row['error'][:60]}")
        else:
            print(f"{name:<18} {row['top1_acc']:>7.2f} {row['ece']:>7.2f} "
                  f"{row['aece']:>7.2f} {row['num_classes']:>6} {row['num_images']:>7}")
    print(f"Wrote {out}")
    if failures:
        raise SystemExit(f"{failures} variant(s) failed")


if __name__ == "__main__":
    main()
