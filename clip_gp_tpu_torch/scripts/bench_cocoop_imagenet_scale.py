"""ImageNet-scale CoCoOp on the trial-batched backend, the JAX package's
``scripts/bench_cocoop_imagenet_scale.py`` on the port.

BASELINE config #4 runs CoCoOp over the 11-dataset suite, which includes
ImageNet (K=1000). At T=5 trials × B=32 × K=1000, one trial-batched step
sends 160k differentiated conditional prompts through the text tower (K1/K2
forward and in the checkpoint recompute, K4/K3 backward), in chunks of at
most ``PROMPT_BUDGET`` prompts per trial, each a ``torch.utils.checkpoint``
segment. On the TPU the question was a dispatch-length ceiling; on the card
it is memory, so the report gives the peak device memory
(``torch.cuda.max_memory_allocated``) beside the group's seconds, and the
micro-slice count the runner used (``cocoop_microbatch_images``,
``CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS``; one pass per step when unset).
The JAX script's K bucketing (``k_pad``) is not ported: the class axis is
never padded.

It drives the production path (``run_vmapped_trials``) at that shape —
Synthetic K=1000, 1-shot, 1 epoch, 5 seeds, ViT-B/16 — and writes
``build/scripts/BENCH_cocoop_imagenet_scale.json``. Knobs:
BENCH_INKSCALE_CLASSES (1000), BENCH_INKSCALE_SEEDS (5),
BENCH_INKSCALE_SHOTS (1), BENCH_INKSCALE_EPOCHS (1).

    python -m clip_gp_tpu_torch.scripts.bench_cocoop_imagenet_scale
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import torch

from clip_gp_tpu_torch.scripts._common import (
    bench_context,
    prompt_config,
    sample_splits,
    write_artifact,
)

SEEDS = list(range(1, 1 + int(os.environ.get("BENCH_INKSCALE_SEEDS", "5"))))
CLASSES = int(os.environ.get("BENCH_INKSCALE_CLASSES", "1000"))
SHOTS = int(os.environ.get("BENCH_INKSCALE_SHOTS", "1"))
EPOCHS = int(os.environ.get("BENCH_INKSCALE_EPOCHS", "1"))


def run(seeds=SEEDS, classes: int = CLASSES, shots: int = SHOTS,
        epochs: int = EPOCHS, backbone: str = "ViT-B/16",
        image_size: int = 224, workers: int = 8) -> dict:
    from clip_gp_tpu_torch.core.device import device_label, resolve_device
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )
    from clip_gp_tpu_torch.data.pipeline import build_data_manager
    from clip_gp_tpu_torch.methods.coop import trimmed_prompt_len
    from clip_gp_tpu_torch.models.tokenizer import tokenize
    from clip_gp_tpu_torch.parallel.trial_specs import cocoop_microbatch_images
    from clip_gp_tpu_torch.parallel.trial_vmap import run_vmapped_trials

    seeds = list(seeds)
    device = resolve_device()
    with bench_context("bench_inkscale_") as tmp:
        gen_t0 = time.time()
        # 4 images/class: ~2 train (covers the 1-shot draw), ~1 val, ~1 test —
        # keeps the forward-only final eval (n_test x T x K conditional
        # prompts) from dwarfing the train phase under test
        generate_synthetic_imagefolder(
            tmp, num_classes=classes, images_per_class=4,
            image_size=image_size, seed=0, fmt="jpg",
        )
        gen_s = time.time() - gen_t0
        config = prompt_config(tmp, "Adapter-CoCoOp", shots, backbone,
                               image_size, epochs, 4, workers)
        config.seed = seeds[0]
        sample_splits(config, seeds)

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        results = run_vmapped_trials(config, seeds, method="Adapter-CoCoOp")
        group_s = time.time() - t0
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None)
        if len(results) != len(seeds) or any(
                r["metrics"]["top1_acc"] != r["metrics"]["top1_acc"]
                for r in results):
            raise RuntimeError("missing or NaN trial results")

        # the runner's sizing inputs, derived as the spec derives them
        dm = build_data_manager(copy.deepcopy(config))
        n_ctx = int(config.adapter.n_ctx)
        tokenized = torch.from_numpy(tokenize(
            [f"{' '.join(['X'] * n_ctx)} {n}." for n in dm.dataset.classnames]))
        prompt_len = trimmed_prompt_len(tokenized, n_ctx, 77 - 1 - n_ctx)
    t = len(seeds)
    b = config.dataloader.batch_size_train
    mb = cocoop_microbatch_images(t, b, classes)
    out = {
        "metric": "cocoop_imagenet_scale_vmap_group_s",
        "value": round(group_s, 1),
        "unit": "s",
        "seeds": t,
        "classes": classes,
        "prompt_len": int(prompt_len),
        "shots": shots,
        "epochs": epochs,
        "batch_size": b,
        "step_prompt_encodes": t * b * classes,
        "microbatch_images": mb,
        "grad_dispatches_per_step": -(-b // mb),
        "peak_device_memory_gib": None if peak is None else round(peak, 3),
        "dataset_gen_s": round(gen_s, 1),
        "device": device_label(device),
        "note": "production run_vmapped_trials at the BASELINE #4 ImageNet "
                "shape; on the card a step is bounded by memory, not by a "
                "dispatch ceiling, so the peak device memory is the result "
                "beside the group time",
    }
    write_artifact("BENCH_cocoop_imagenet_scale.json", out)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
