"""Sweep-cell benchmark, the JAX package's ``scripts/bench_sweep.py`` on
the port: 5 seeds × 2 GP betas trained as ONE trial-batched group at
realistic scale (100 classes × 16 shots of 224px images, ViT-B/16, 100 GP
epochs, S=30/300).

This is the unit the reference schedules as 10 separate GPU subprocesses;
here the frozen tower encodes the seed-union once (K1/K2) and all 10 trials
advance together on one card. Prints a JSON report with the wall-clock
split.

    python -m clip_gp_tpu_torch.scripts.bench_sweep
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
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )
    from clip_gp_tpu_torch.parallel.trial_vmap import run_seed_vmapped_adapter

    with bench_context("bench_sweep_") as tmp:
        t0 = time.time()
        generate_synthetic_imagefolder(
            tmp, num_classes=num_classes, images_per_class=images_per_class,
            image_size=image_size, seed=0,
        )
        gen_s = time.time() - t0
        c = gp_config(tmp, shots, backbone, image_size, epochs, workers)
        seeds = [1, 2, 3, 4, 5] * 2
        overrides = [{"gp_beta": 0.001}] * 5 + [{"gp_beta": 0.1}] * 5
        outdirs = [os.path.join(tmp, f"out/t{i}") for i in range(10)]
        t0 = time.time()
        results = run_seed_vmapped_adapter(c, seeds, outdirs,
                                           trial_overrides=overrides)
        sweep_s = time.time() - t0
    return {
        "sweep_cell_trials": len(results),
        "sweep_cell_s": round(sweep_s, 1),
        "s_per_trial": round(sweep_s / len(results), 1),
        "dataset_gen_s": round(gen_s, 1),
        "epochs": epochs,
        "backbone": backbone,
        "accs": [round(r["metrics"]["top1_acc"], 1) for r in results],
        "device": device_label(),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
