"""End-to-end trial benchmark, the JAX package's ``scripts/bench_trial.py``
on the port: the flagship Adapter+GP trial at real shapes.

Times one full trial (the unit the sweep runner schedules 30× per dataset)
with real tower sizes and the real image pipeline on generated data:
100 classes × 16 shots of 224px images, ViT-B/16 (random weights —
throughput does not depend on them), 100 training epochs, S=30/300 MC
sampling, full eval. Every frozen encode runs K1/K2 in each block.

Prints a JSON object with the per-phase wall-clock breakdown of
``runtime/profiling.py`` (each phase ended by a CUDA synchronize): host
decode and device extract (``feature_extraction``) against the GP fit
(``train_epochs``).

    python -m clip_gp_tpu_torch.scripts.bench_trial
"""

from __future__ import annotations

import argparse
import json
import os
import time

from clip_gp_tpu_torch.scripts._common import bench_context, gp_config


def run(num_classes: int = 100, images_per_class: int = 36,
        image_size: int = 224, shots: int = 16, backbone: str = "ViT-B/16",
        epochs: int = 100, workers=None) -> dict:
    from clip_gp_tpu_torch.core.device import device_label
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )
    from clip_gp_tpu_torch.data.pipeline import build_data_manager
    from clip_gp_tpu_torch.runtime import profiling

    with bench_context("bench_trial_") as tmp:
        t0 = time.time()
        generate_synthetic_imagefolder(
            tmp, num_classes=num_classes, images_per_class=images_per_class,
            image_size=image_size, seed=0,
        )
        gen_s = time.time() - t0

        c = gp_config(tmp, shots, backbone, image_size, epochs, workers)
        c.optim.name = "adamw"
        c.output_dir = os.path.join(tmp, "out")

        set_random_seed(c.seed)
        profiling.reset_phases()
        t0 = time.time()
        dm = build_data_manager(c)
        trainer = build_trainer(c, dm)
        trainer.train()
        total_s = time.time() - t0

        with open(os.path.join(c.output_dir, "metrics.json")) as f:
            payload = json.load(f)

    return {
        "total_trial_s": round(total_s, 1),
        "dataset_gen_s": round(gen_s, 1),
        "phases": {
            k: round(v["total_s"], 2)
            for k, v in profiling.phase_report().items()
        },
        "n_train": len(dm.dataset.train_x),
        "n_test": len(dm.dataset.test),
        "num_classes": dm.num_classes,
        "final_acc": round(payload["metrics"]["accuracy"], 2),
        "backbone": backbone,
        "epochs": epochs,
        "device": device_label(),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
