"""CoCoOp trial-group benchmark: the trial-batched runner against
in-process trials at real shapes, the JAX package's
``scripts/bench_cocoop_vmap.py`` on the port.

``parallel/trial_specs.py``'s ``CoCoOpSpec`` trains T seeds at once: the
context and meta-net carry a leading [T], and each chunk of C images sends
its T·C·K conditional prompts through one text-tower call (K1/K2 forward
and in the checkpoint recompute, K4/K3 backward). BASELINE config #4 runs
CoCoOp over the 11-dataset suite, so the unit measured here is a 5-seed
(dataset, shots) cell.

Protocol as ``bench_coop_vmap``'s: the trial-batched group once cold (the
first launches' kernel-library load, allocations and cuDNN algorithm
choice), the in-process group modeled as cold + (T−1)·warm trials; the warm
passes of the two modes interleave (group, trial, group, trial; the least
of each counts). ``CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS`` sets the
trial-batched step's micro-slice budget (``cocoop_microbatch_images``);
``CLIP_GP_TPU_TORCH_PROMPT_TOWER_DTYPE`` the tower's dtype. Each cell is
kept, by shape, in ``build/scripts/BENCH_cocoop_vmap.json``. Knobs:
``BENCH_COCOOP_EPOCHS`` (3), ``BENCH_COCOOP_CLASSES`` (50),
``BENCH_COCOOP_SHOTS`` (16).

    python -m clip_gp_tpu_torch.scripts.bench_cocoop_vmap
"""

from __future__ import annotations

import argparse
import json
import os

from clip_gp_tpu_torch.scripts._common import (
    bench_context,
    prompt_config,
    read_artifact,
    sample_splits,
    write_artifact,
)
from clip_gp_tpu_torch.scripts.bench_coop_vmap import SEEDS, run_group, run_inprocess

ARTIFACT = "BENCH_cocoop_vmap.json"
EPOCHS = int(os.environ.get("BENCH_COCOOP_EPOCHS", "3"))
CLASSES = int(os.environ.get("BENCH_COCOOP_CLASSES", "50"))
SHOTS = int(os.environ.get("BENCH_COCOOP_SHOTS", "16"))


def run(epochs: int = EPOCHS, classes: int = CLASSES, shots: int = SHOTS,
        seeds=SEEDS, images_per_class=None, backbone: str = "ViT-B/16",
        image_size: int = 224, n_ctx: int = 4, workers: int = 8) -> dict:
    from clip_gp_tpu_torch.core.device import device_label
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )
    from clip_gp_tpu_torch.parallel.trial_specs import cocoop_microbatch_images

    seeds = list(seeds)
    with bench_context("bench_cocoop_") as tmp:
        generate_synthetic_imagefolder(
            tmp, num_classes=classes,
            images_per_class=images_per_class or max(shots + 4, 20),
            image_size=image_size, seed=0, fmt="jpg",
        )
        # CoCoOp's configs use short contexts (ctx_init length)
        config = prompt_config(tmp, "Adapter-CoCoOp", shots, backbone,
                               image_size, epochs, n_ctx, workers)
        sample_splits(config, seeds)
        method = "Adapter-CoCoOp"
        vmap_s = run_group(config, seeds, method)  # cold
        cold_s = run_inprocess(config, seeds[0])  # cold in-process trial
        vmap_w1 = run_group(config, seeds, method)
        inproc_w1 = run_inprocess(config, seeds[1])
        vmap_w2 = run_group(config, seeds, method)
        inproc_w2 = run_inprocess(config, seeds[1])
    vmap_warm_s = min(vmap_w1, vmap_w2)
    warm_s = min(inproc_w1, inproc_w2)
    group_inproc_s = cold_s + warm_s * (len(seeds) - 1)
    batch = int(config.dataloader.batch_size_train)
    payload = {
        "metric": "cocoop_seed_group_time_s",
        "seeds": len(seeds),
        "classes": classes,
        "shots": shots,
        "epochs": epochs,
        "microbatch_images": cocoop_microbatch_images(len(seeds), batch, classes),
        "prompt_tower_dtype": os.environ.get(
            "CLIP_GP_TPU_TORCH_PROMPT_TOWER_DTYPE", "float32"),
        "vmapped_group_s": round(vmap_s, 1),
        "vmapped_group_warm_s": round(vmap_warm_s, 1),
        "inprocess_trial_cold_s": round(cold_s, 1),
        "inprocess_trial_warm_s": round(warm_s, 1),
        "inprocess_group_s": round(group_inproc_s, 1),
        "speedup": round(group_inproc_s / vmap_s, 2),
        "speedup_warm": round(warm_s * len(seeds) / vmap_warm_s, 2),
        "baseline_note": "group modeled as cold + (T-1)*warm trials; "
                         "speedup_warm compares steady states (warm "
                         "trial-batched group vs T warm sequential trials)",
        "device": device_label(),
    }
    # per-shape cells accumulate in one artifact (the routing question
    # depends on K, T and the budget)
    cells = (read_artifact(ARTIFACT) or {}).get("cells", {})
    key = f"k{classes}_shots{shots}_e{epochs}_t{len(seeds)}"
    if payload["microbatch_images"] != batch:
        key += f"_mb{payload['microbatch_images']}"
    cells[key] = payload
    write_artifact(ARTIFACT, {"metric": "cocoop_seed_group_time_s", "cells": cells})
    return payload


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
