"""Smoke test: run every method for a few epochs on one dataset in throwaway
temp dirs and report OK/FAIL per method, as the JAX package's
``scripts/quick_check.py`` does.

By default it uses the synthetic dataset and the tiny random-weight TEST-ViT
towers; pass --dataset/--backbone/--root to smoke real data instead.

    python -m clip_gp_tpu_torch.scripts.quick_check [--epochs 3]

On the CPU, prefix ``CLIP_GP_TPU_TORCH_FORCE_CPU=1``. A TEST backbone sets
``CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS=1`` unless it is set. A method
that writes no metrics.json is reported FAIL; one that raises stops the
run with its traceback (the JAX script reports it FAIL and goes on: the
port's scripts catch no error but running out of device memory).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

METHODS = [
    ("baseline", "Adapter", {}),
    ("gp", "Adapter", {"use_gp": True, "gp_pca_dim": 8}),
    ("coop", "Adapter-CoOp", {"n_ctx": 2}),
    ("cocoop", "Adapter-CoCoOp", {"n_ctx": 2}),
    ("clip-adapter", "CLIP-Adapter", {}),
    ("taskres", "TaskRes", {}),
    ("tipa", "Tip-Adapter", {}),
    ("tipa-f", "Tip-Adapter-F", {}),
]


def run_one(label, trainer_name, overrides, dataset, backbone, root,
            epochs) -> bool:
    from clip_gp_tpu_torch.core.config import Config
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager

    with tempfile.TemporaryDirectory() as tmp:
        c = Config()
        c.trainer_name = trainer_name
        c.dataset.name = dataset
        c.dataset.root = root or os.path.join(tmp, "data")
        c.dataset.num_shots = 4
        c.model.backbone_name = backbone
        if backbone.startswith("TEST"):
            c.input.size = (32, 32)
        c.dataloader.batch_size_train = 8
        c.dataloader.batch_size_test = 16
        c.dataloader.num_workers = 2
        c.adapter.num_templates = 2
        c.adapter.clip_adapter_epochs = epochs
        c.adapter.taskres_epochs = epochs
        c.adapter.tip_adapter_epochs = epochs
        c.adapter.gp_num_mc_samples_train = 4
        c.adapter.gp_num_mc_samples_eval = 8
        c.optim.max_epoch = epochs
        c.train.print_freq = 1000
        c.output_dir = os.path.join(tmp, "out")
        c.seed = 1
        for k, v in overrides.items():
            setattr(c.adapter, k, v)
        set_random_seed(c.seed)
        dm = build_data_manager(c)
        trainer = build_trainer(c, dm)
        trainer.train()
        return os.path.exists(os.path.join(c.output_dir, "metrics.json"))


def run(dataset: str = "Synthetic", backbone: str = "TEST-ViT",
        root=None, epochs: int = 3) -> dict:
    """Every row of ``METHODS``: ``{"results": {label: passed}, ...}``."""
    from clip_gp_tpu_torch.core.device import device_label

    if backbone.startswith("TEST"):
        os.environ.setdefault("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401

    results = {}
    for label, trainer_name, overrides in METHODS:
        print(f"\n===== quick check: {label} =====")
        results[label] = run_one(label, trainer_name, overrides, dataset,
                                 backbone, root, epochs)
    return {"metric": "quick_check", "dataset": dataset, "backbone": backbone,
            "epochs": epochs, "results": results, "device": device_label()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="Synthetic")
    ap.add_argument("--backbone", default="TEST-ViT")
    ap.add_argument("--root", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    report = run(args.dataset, args.backbone, args.root, args.epochs)

    print("\n===== summary =====")
    for label, passed in report["results"].items():
        print(f"{label:14s} {'OK' if passed else 'FAIL'}")
    print(json.dumps(report))
    return 0 if all(report["results"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
