"""BASELINE #3/#4 sweep-shape benchmark on the trial-batched backend, one
command: the JAX package's ``scripts/bench_sweep_methods.py`` on the port.

It drives ``parallel/trial_vmap.py``'s ``run_vmapped_trials`` directly —
bypassing the sweep router, so no cell can route in-process — over
synthetic datasets shaped like the BASELINE configs:

- **#3**: OxfordPets(37) / DTD(47) / EuroSAT(10)-class datasets ×
  {CLIP-Adapter, TaskRes, Tip-Adapter-F} × 5 seeds;
- **#4**: CoOp (and CoCoOp unless skipped) × representative class counts of
  the 11-dataset suite × 5 seeds, ViT-B/16.

Emits one JSON line (also ``build/scripts/BENCH_sweep_methods.json``, and
after every cell ``build/scripts/BENCH_sweep_methods.partial.json``) with
per-cell group times, trials/s and the projected full-suite wall clock. A
cell that runs out of device memory is listed under ``failed_cells``; any
other error raises, and no cell is retried. The JAX script's
``k_bucket_trio_s`` is not reported: the port pads no class axis
(``parallel/k_bucket.py`` is not ported), so the 100/101/102-class cells
share nothing. Envs: BENCH_METHODS_SHOTS (default "16"),
BENCH_METHODS_EPOCHS (10), BENCH_METHODS_PROMPT_EPOCHS (2),
BENCH_METHODS_SEEDS ("1,2,3,4,5"), BENCH_METHODS_BACKBONE (ViT-B/16),
BENCH_METHODS_SKIP_COCOOP=1, BENCH_METHODS_SMOKE=1 (one small dataset per
family), BENCH_METHODS_ONLY="<method>/<dataset>,..." (matching cells only).

    python -m clip_gp_tpu_torch.scripts.bench_sweep_methods
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

from clip_gp_tpu_torch.scripts._common import (
    bench_context,
    sample_splits,
    synthetic_config,
    write_artifact,
)

SEEDS = [int(s) for s in
         os.environ.get("BENCH_METHODS_SEEDS", "1,2,3,4,5").split(",")]
SHOTS = [int(s) for s in os.environ.get("BENCH_METHODS_SHOTS", "16").split(",")]
EPOCHS = int(os.environ.get("BENCH_METHODS_EPOCHS", "10"))
# prompt methods re-encode K (CoOp) or B·K (CoCoOp) prompts through the text
# tower every step, so the witness runs them for fewer epochs (group time
# scales about linearly in epochs; the payload records both counts)
PROMPT_EPOCHS = int(os.environ.get("BENCH_METHODS_PROMPT_EPOCHS", "2"))
BACKBONE = os.environ.get("BENCH_METHODS_BACKBONE", "ViT-B/16")
# BASELINE #3 dataset shapes (classes as in the real catalogs)
DATASETS_3 = {"oxford_pets": 37, "dtd": 47, "eurosat": 10}
METHODS_3 = ["CLIP-Adapter", "TaskRes", "Tip-Adapter"]
# BASELINE #4: representative class counts of the 11-dataset CoOp suite
# (eurosat 10, dtd 47, and three of the five ~100-class datasets)
DATASETS_4 = {
    "eurosat": 10, "dtd": 47,
    "caltech101_like": 100, "food101_like": 101, "flowers_like": 102,
}
METHODS_4 = ["Adapter-CoOp"] + (
    [] if os.environ.get("BENCH_METHODS_SKIP_COCOOP") == "1"
    else ["Adapter-CoCoOp"]
)
SMOKE = os.environ.get("BENCH_METHODS_SMOKE") == "1"
ONLY = [s for s in os.environ.get("BENCH_METHODS_ONLY", "").split(",") if s]
FULL_SUITE_SHOTS = 5    # {1,2,4,8,16}
FULL_SUITE_DATASETS_3 = 3
FULL_SUITE_DATASETS_4 = 11
PROMPT_METHODS = ("Adapter-CoOp", "Adapter-CoCoOp")


def _config(root, method, shots, backbone, image_size, epochs, prompt_epochs,
            workers):
    c = synthetic_config(root, shots, backbone, image_size, 32, workers=workers)
    c.trainer_name = method
    c.adapter.num_templates = 8
    e = prompt_epochs if method in PROMPT_METHODS else epochs
    c.adapter.clip_adapter_epochs = e
    c.adapter.taskres_epochs = e
    c.adapter.tip_adapter_epochs = e
    c.adapter.tip_adapter_trainable = True  # the -F variant
    c.adapter.n_ctx = 4
    c.optim.max_epoch = e
    c.train.print_freq = 10**9
    return c


def run(seeds=SEEDS, shots=SHOTS, epochs: int = EPOCHS,
        prompt_epochs: int = PROMPT_EPOCHS, backbone: str = BACKBONE,
        datasets_3=None, datasets_4=None, methods_4=METHODS_4,
        smoke: bool = SMOKE, only=ONLY, image_size=None,
        workers=None) -> dict:
    from clip_gp_tpu_torch.core.device import device_label
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )
    from clip_gp_tpu_torch.parallel.sweep import _vmap_supported
    from clip_gp_tpu_torch.parallel.trial_vmap import run_vmapped_trials
    from clip_gp_tpu_torch.runtime import feature_cache

    seeds, shots, only = list(seeds), list(shots), list(only)
    if datasets_3 is None:
        datasets_3 = {"eurosat": 10} if smoke else DATASETS_3
    if datasets_4 is None:
        datasets_4 = {"eurosat": 10} if smoke else DATASETS_4
    if image_size is None:
        image_size = 224 if backbone.startswith(("ViT-B", "RN")) else 32
    cells, failed = {}, {}

    def selected(method, ds_name):
        return not only or any(f"{method}/{ds_name}".startswith(s) for s in only)

    with bench_context("bench_methods_",
                       CLIP_GP_TPU_TORCH_NATIVE_DECODE="1") as tmp:
        roots = {}
        gen_t0 = time.time()
        for name, k in {**datasets_3, **datasets_4}.items():
            root = os.path.join(tmp, name)
            generate_synthetic_imagefolder(
                root, num_classes=k, images_per_class=max(max(shots) + 4, 20),
                image_size=image_size, seed=0, fmt="jpg",
            )
            roots[name] = root
        gen_s = time.time() - gen_t0

        def run_cell(method, ds_name, k, n_shots):
            """One (method, dataset, shots) seed group, trial-batched."""
            key = f"{method}/{ds_name}/{n_shots}shot"
            config = _config(roots[ds_name], method, n_shots, backbone,
                             image_size, epochs, prompt_epochs, workers)
            if not _vmap_supported(config, len(seeds)):
                raise ValueError(f"{key}: not trial-batchable")
            sample_splits(config, seeds)
            feature_cache.memo_clear()
            try:
                t0 = time.time()
                results = run_vmapped_trials(copy.deepcopy(config), seeds,
                                             method=method)
                cells[key] = time.time() - t0
            except torch.cuda.OutOfMemoryError as e:
                failed[key] = repr(e)
                torch.cuda.empty_cache()
                print(f"# {key}: FAILED: {e!r}", file=sys.stderr)
            else:
                if len(results) != len(seeds) or any(
                        r["metrics"]["top1_acc"] != r["metrics"]["top1_acc"]
                        for r in results):
                    raise RuntimeError(f"{key}: missing or NaN trial results")
                print(f"# {key}: {cells[key]:.1f}s", file=sys.stderr)
            write_artifact("BENCH_sweep_methods.partial.json", {
                "cells": {k_: round(v, 1) for k_, v in cells.items()},
                "failed": failed})

        for methods, datasets in ((METHODS_3, datasets_3), (methods_4, datasets_4)):
            for method in methods:
                for ds_name, k in datasets.items():
                    for n_shots in shots:
                        if selected(method, ds_name):
                            run_cell(method, ds_name, k, n_shots)

    trials_run = len(cells) * len(seeds)
    total_s = sum(cells.values())
    # full-suite projection: measured mean group time per family × the full
    # grid's group count (16-shot groups are the most expensive cells, so
    # projecting lower shot counts at the measured mean over-counts)
    family_3 = [v for k_, v in cells.items() if k_.split("/")[0] in METHODS_3]
    mean_3 = sum(family_3) / max(1, len(family_3))
    groups_3 = len(METHODS_3) * FULL_SUITE_DATASETS_3 * FULL_SUITE_SHOTS
    payload = {
        "metric": "baseline34_sweep_vmap",
        "seeds": len(seeds),
        "epochs": epochs,
        "prompt_epochs": prompt_epochs,
        "shots_measured": shots,
        "trials_run": trials_run,
        "trials_per_s": round(trials_run / total_s, 3) if total_s else None,
        "measured_total_s": round(total_s, 1),
        "group_s_by_cell": {k_: round(v, 1) for k_, v in cells.items()},
        "config3_projection_min": round(mean_3 * groups_3 / 60, 1),
        "config3_projection_note": (
            f"{groups_3} groups (3 methods x 3 datasets x 5 shot-counts) at "
            "the measured mean group time; 16-shot measured cells are the "
            "most expensive, so this over-counts lower-shot cells"
        ),
        # run_vmapped_trials is called directly (no sweep router): every cell
        # in group_s_by_cell ran trial-batched; cells that ran out of device
        # memory are in failed_cells
        "zero_vmap_fallbacks": True,
        "backbone": backbone,
        "device": device_label(),
        "dataset_gen_s": round(gen_s, 1),
    }
    if failed:
        payload["failed_cells"] = failed
    if smoke:
        payload["smoke"] = True  # reduced grid — projections not meaningful
    if methods_4:
        mean_4 = {}
        for m in methods_4:
            family = [v for k_, v in cells.items() if k_.startswith(m + "/")]
            mean_4[m] = sum(family) / max(1, len(family))
        proj_4 = sum(mean_4[m] * FULL_SUITE_DATASETS_4 * FULL_SUITE_SHOTS
                     for m in methods_4)
        payload["config4_projection_min"] = round(proj_4 / 60, 1)
        payload["config4_projection_note"] = (
            f"{len(methods_4)} prompt method(s) x {FULL_SUITE_DATASETS_4} "
            f"datasets x {FULL_SUITE_SHOTS} shot-counts at each method's "
            "measured mean group time over representative class counts "
            f"(10/47/100/101/102) at {prompt_epochs} epochs (group time "
            "scales about linearly in epochs); ImageNet-scale K not run"
        )
    if only:
        payload["cells_filtered_by"] = only  # triage run, partial grid
    if not smoke and not only:
        write_artifact("BENCH_sweep_methods.json", payload)
    return payload


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
