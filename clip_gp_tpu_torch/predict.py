"""Serving entry: classify images with a trained run directory.

The counterpart of the JAX package's ``scripts/predict.py``: point it at a
trained run's output directory and either a folder of images or a dataset
split, and it writes top-k predictions with calibrated confidences to
``predictions.json`` (the same schema). The run's configuration is reloaded
from its ``config.json`` and the class vocabulary comes from the checkpoint
itself (``__classnames__``), so folder prediction needs neither the
training dataset on disk nor any flag replay.

Usage (on the GPU; ``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` runs it on the CPU):

  # a folder of images (recursive), class names from the checkpoint:
  python -m clip_gp_tpu_torch.predict --model-dir output/caltech/gp/seed1 \\
      --images /path/to/photos --topk 5 --output preds.json

  # a registered dataset split (adds a top-1/ECE/AECE summary):
  python -m clip_gp_tpu_torch.predict --model-dir output/caltech/gp/seed1 --split test

``--int8`` serves the frozen ViT image tower through the int8 kernels K5/K6
(``models/quantized.py``). The JAX script's persistent XLA compile cache
(``compile_cache.enable()``) has no counterpart here: PyTorch runs eagerly
and the CUDA kernels are built once into ``build/kernels/``.
``CLIP_GP_TPU_TORCH_PROFILE_DIR=<dir>`` writes a ``torch.profiler`` trace of
the job (extraction and logits) under ``<dir>/predict/``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif"}


class _PredictDataset:
    """Minimal dataset carrying only the class vocabulary."""

    def __init__(self, classnames):
        self.classnames = list(classnames)
        self.num_classes = len(self.classnames)
        self.lab2cname = dict(enumerate(self.classnames))
        self.train_x = []
        self.val = []
        self.test = []


class _PredictDataManager:
    """Loader-free stand-in for DataManager: the trainers need only the class
    vocabulary to rebuild their frozen text side."""

    def __init__(self, classnames):
        self.dataset = _PredictDataset(classnames)
        self.train_loader_x = None
        self.val_loader = None
        self.test_loader = None
        self.num_classes = self.dataset.num_classes
        self.lab2cname = self.dataset.lab2cname


def list_images(root: Path):
    files = [
        p for p in sorted(root.rglob("*"))
        if p.is_file() and p.suffix.lower() in IMAGE_EXTS
    ]
    if not files:
        raise SystemExit(f"no images found under {root}")
    return files


def _positive_int(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return iv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", required=True,
                    help="trained run output dir (config.json + adapter/)")
    ap.add_argument("--images", default=None,
                    help="folder of images (recursive); mutually exclusive "
                         "with --split")
    ap.add_argument("--split", default=None, choices=["test", "val", "train"],
                    help="registered dataset split from the run's config")
    ap.add_argument("--output", default=None,
                    help="output JSON path (default <model-dir>/predictions.json)")
    ap.add_argument("--topk", type=_positive_int, default=5)
    ap.add_argument("--batch-size", type=_positive_int, default=None)
    ap.add_argument("--load-epoch", type=int, default=None)
    ap.add_argument("--int8", action="store_true",
                    help="serve the frozen ViT image tower with int8 products "
                         "(models/quantized.py, kernels K5/K6; a small "
                         "feature perturbation)")
    args = ap.parse_args(argv)
    if (args.images is None) == (args.split is None):
        ap.error("exactly one of --images / --split is required")

    import numpy as np
    import torch

    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401
    from clip_gp_tpu_torch.core.config import config_from_dict
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.datum import Datum
    from clip_gp_tpu_torch.data.pipeline import BatchLoader, build_data_manager
    from clip_gp_tpu_torch.data.transforms import build_transform
    from clip_gp_tpu_torch.runtime.profiling import maybe_trace
    from clip_gp_tpu_torch.runtime.trainer_base import (
        read_checkpoint_classnames,
        resolve_checkpoint_path,
    )

    model_dir = Path(args.model_dir)
    cfg_path = model_dir / "config.json"
    if not cfg_path.exists():
        raise SystemExit(f"missing {cfg_path} — not a run directory?")
    with cfg_path.open() as f:
        config = config_from_dict(json.load(f))
    if args.batch_size:
        config.dataloader.batch_size_test = args.batch_size
        config.dataloader.batch_size_train = args.batch_size  # --split train
    if args.int8:
        config.model.int8_inference = True

    ckpt = resolve_checkpoint_path(str(model_dir), args.load_epoch)
    if ckpt is None:
        raise SystemExit(f"no checkpoint under {model_dir / 'adapter'}")

    set_random_seed(max(int(config.seed), 0))
    t0 = time.time()
    eval_loader = None
    if args.images is not None:
        classnames = read_checkpoint_classnames(ckpt)
        if classnames is None:
            raise SystemExit(
                f"{ckpt} stores no classnames; use --split to rebuild the "
                "vocabulary from the dataset"
            )
        dm = _PredictDataManager(classnames)
        paths = list_images(Path(args.images))
        source = [Datum(impath=str(p), label=0) for p in paths]
        labels = None
    else:
        dm = build_data_manager(config)
        source = {
            "test": dm.dataset.test,
            "val": dm.dataset.val,
            "train": dm.dataset.train_x,
        }[args.split]
        if not source:
            raise SystemExit(f"run has no {args.split} split")
        paths = [Path(d.impath) for d in source]
        labels = np.asarray([d.label for d in source])
        classnames = dm.dataset.classnames
    if args.images is not None or args.split == "train":
        # serving is deterministic: the train images too go through the EVAL
        # transform (extract_features("train") would augment them)
        eval_loader = BatchLoader(
            source,
            build_transform(config, is_train=False),
            config.dataloader.batch_size_test,
            num_workers=config.dataloader.num_workers,
        )

    trainer = build_trainer(config, dm)
    trainer.build_model()
    if trainer.load_model(str(model_dir), epoch=args.load_epoch) == 0:
        raise SystemExit("checkpoint reload failed")

    with maybe_trace("predict", device=trainer.device):
        if eval_loader is not None:
            _, feats = trainer.encode_images_batched(eval_loader)
            with torch.no_grad():
                logits = trainer.predict_logits(
                    torch.from_numpy(feats).to(trainer.device)).cpu().numpy()
        else:
            _, logits, _ = trainer.extract_features(args.split)
    z = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(z)
    probs = e / e.sum(axis=1, keepdims=True)
    k = min(args.topk, probs.shape[1])
    top_idx = np.argsort(-probs, axis=1)[:, :k]

    predictions = [
        {
            "path": str(p),
            "topk": [
                {
                    "classname": classnames[int(c)],
                    "label": int(c),
                    "prob": round(float(probs[i, c]), 6),
                }
                for c in top_idx[i]
            ],
        }
        for i, p in enumerate(paths)
    ]
    payload = {
        "model_dir": str(model_dir),
        "checkpoint": str(ckpt),
        "backbone": config.model.backbone_name,
        "num_classes": len(classnames),
        "num_images": len(paths),
        "elapsed_s": round(time.time() - t0, 2),
        "predictions": predictions,
    }
    if labels is not None:
        from clip_gp_tpu_torch.ops.metrics import compute_aece, compute_ece

        top1 = float((top_idx[:, 0] == labels).mean() * 100)
        payload["summary"] = {
            "split": args.split,
            "top1_acc": round(top1, 4),
            "ece": round(float(compute_ece(logits, labels)), 4),
            "aece": round(float(compute_aece(logits, labels)), 4),
        }
        print(f"{args.split}: top-1 {top1:.2f}% over {len(paths)} images")

    out = Path(args.output) if args.output else model_dir / "predictions.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        json.dump(payload, f, indent=2)
    print(f"Wrote {len(paths)} predictions to {out}")
    return payload


if __name__ == "__main__":
    main()
