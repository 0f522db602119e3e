"""CoOp trial-group benchmark: the trial-batched runner against in-process
trials at real shapes, the JAX package's ``scripts/bench_coop_vmap.py`` on
the port.

BASELINE config #4's sweep unit is a CoOp seed group (5 seeds per
dataset/shot cell). The trial-batched runner trains the group at once — the
text tower encodes T·K prompts per step (K1/K2 forward, K4/K3 backward) and
the frozen image tower encodes the UNION of the seeds' few-shot images once
per epoch — while the in-process path runs T trials one after another,
each with its own per-epoch encodes and K-prompt text passes.

Measures both at realistic scale (default: 50 classes × 16 shots of 224px
JPEGs, ViT-B/16 random weights, n_ctx=16, batch 32) and prints one JSON
line with wall-clocks and the group-level speedup.

The trial-batched group is timed twice. The first ("cold") pass pays what
a process pays once on the card: the kernel library's build or load at the
first launch (``ops/_build.py``), the caching allocator's first
allocations and cuDNN's first choice of convolution algorithms; CLIP
load, split reading and the image decode are paid by every pass and every
trial. The in-process group is modeled as one cold trial + (T−1) warm
trials. Knobs: ``BENCH_COOP_EPOCHS`` (6), ``BENCH_COOP_CLASSES`` (50).

    python -m clip_gp_tpu_torch.scripts.bench_coop_vmap
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

from clip_gp_tpu_torch.scripts._common import (
    bench_context,
    prompt_config,
    sample_splits,
)

SEEDS = [1, 2, 3, 4, 5]
EPOCHS = int(os.environ.get("BENCH_COOP_EPOCHS", "6"))
CLASSES = int(os.environ.get("BENCH_COOP_CLASSES", "50"))


def run_group(config, seeds, method) -> float:
    """Seconds of one trial-batched group, from an empty feature memo."""
    from clip_gp_tpu_torch.parallel.trial_vmap import run_vmapped_trials
    from clip_gp_tpu_torch.runtime import feature_cache

    feature_cache.memo_clear()
    t0 = time.time()
    results = run_vmapped_trials(config, seeds, method=method)
    seconds = time.time() - t0
    if len(results) != len(seeds):
        raise RuntimeError(f"{method}: {len(results)} results for {len(seeds)} seeds")
    return seconds


def run_inprocess(config, seed) -> float:
    """Seconds of one in-process trial (trainer build + train), its split
    read before the clock starts."""
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager
    from clip_gp_tpu_torch.runtime import feature_cache

    feature_cache.memo_clear()
    cfg = copy.deepcopy(config)
    cfg.seed = seed
    with tempfile.TemporaryDirectory(prefix="bench_run_") as out:
        cfg.output_dir = out
        set_random_seed(cfg.seed)
        dm = build_data_manager(cfg)
        t0 = time.time()
        build_trainer(cfg, dm).train()
        return time.time() - t0


def run(epochs: int = EPOCHS, classes: int = CLASSES, seeds=SEEDS,
        shots: int = 16, images_per_class: int = 36,
        backbone: str = "ViT-B/16", image_size: int = 224, n_ctx: int = 16,
        workers: int = 8) -> dict:
    from clip_gp_tpu_torch.core.device import device_label
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )

    seeds = list(seeds)
    with bench_context("bench_coop_") as tmp:
        generate_synthetic_imagefolder(
            tmp, num_classes=classes, images_per_class=images_per_class,
            image_size=image_size, seed=0, fmt="jpg",
        )
        config = prompt_config(tmp, "Adapter-CoOp", shots, backbone, image_size,
                               epochs, n_ctx, workers)
        sample_splits(config, seeds)
        vmap_s = run_group(config, seeds, "Adapter-CoOp")
        vmap_warm_s = run_group(config, seeds, "Adapter-CoOp")
        cold_s = run_inprocess(config, seeds[0])
        warm_s = run_inprocess(config, seeds[1])
    group_inproc_s = cold_s + warm_s * (len(seeds) - 1)
    return {
        "metric": "coop_seed_group_time_s",
        "seeds": len(seeds),
        "classes": classes,
        "epochs": epochs,
        "vmapped_group_s": round(vmap_s, 1),
        "vmapped_group_warm_s": round(vmap_warm_s, 1),
        "inprocess_trial_cold_s": round(cold_s, 1),
        "inprocess_trial_warm_s": round(warm_s, 1),
        "inprocess_group_s": round(group_inproc_s, 1),
        "speedup": round(group_inproc_s / vmap_s, 2),
        "speedup_warm": round(warm_s * len(seeds) / vmap_warm_s, 2),
        "baseline_note": "group modeled as cold + (T-1)*warm trials; "
                         "speedup_warm compares steady states (warm "
                         "trial-batched group vs T warm sequential trials); "
                         "cold pays the first launches' kernel-library load, "
                         "allocations and cuDNN algorithm choice",
        "device": device_label(),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
