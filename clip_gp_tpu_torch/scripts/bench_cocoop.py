"""CoCoOp step-time microbenchmark, the JAX package's
``scripts/bench_cocoop.py`` on the port: the chunked text encode at the
default prompt budget against the whole batch's prompts in one call.

The reference loops one image's K prompts at a time through the text tower
(ref: trainers/adapter_cocoop.py:70-82); ``methods/cocoop.py`` sends chunks
of at most ``PROMPT_BUDGET`` (256) conditional prompts through one
text-tower call, each chunk a ``torch.utils.checkpoint`` segment. This bench
times a full CoCoOp train step (meta-net + ctx gradients through the text
tower: K1/K2 forward and in the recompute, K4/K3 backward) at the flagship
shape for the default budget and for B·K (one call for the whole batch),
through the trainer's own ``_train_step`` — no second copy of the step's
math to drift from the shipped one. One step runs before the timed
window, which ends with ``torch.cuda.synchronize()``.

    python -m clip_gp_tpu_torch.scripts.bench_cocoop
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np
import torch

from clip_gp_tpu_torch.scripts._common import bench_context, sync

K = 100  # classes
B = 32  # batch
N_CTX = 4
STEPS = 10


def make_trainer(k: int, backbone: str = "ViT-B/16", n_ctx: int = N_CTX):
    """A CoCoOp trainer over ``k`` made-up class names, with no data."""
    import clip_gp_tpu_torch.methods.cocoop as cocoop_mod
    from clip_gp_tpu_torch.core.config import Config

    config = Config()
    config.model.backbone_name = backbone
    config.adapter.n_ctx = n_ctx
    config.adapter.ctx_init = ""
    config.seed = 1
    classnames = [f"thing {i}" for i in range(k)]
    dm = types.SimpleNamespace(
        dataset=types.SimpleNamespace(classnames=classnames),
        train_loader_x=None,
        val_loader=None,
        test_loader=None,
        num_classes=k,
        lab2cname={i: c for i, c in enumerate(classnames)},
    )
    return cocoop_mod.Trainer(config, dm)


def step_inputs(trainer, k: int, b: int):
    """Normalized random image features [b, D] and labels on the trainer's
    device, from seed 0."""
    rng = np.random.default_rng(0)
    d = int(trainer.arch.embed_dim)
    feats = rng.normal(size=(b, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    labels = rng.integers(0, k, size=b)
    return (torch.from_numpy(feats).to(trainer.device),
            torch.from_numpy(labels).to(trainer.device))


def measure(budget: int, k: int, b: int, steps: int, backbone: str) -> float:
    """ms per ``_train_step`` with ``PROMPT_BUDGET`` = ``budget``."""
    import clip_gp_tpu_torch.methods.cocoop as cocoop_mod

    saved = cocoop_mod.PROMPT_BUDGET
    cocoop_mod.PROMPT_BUDGET = budget
    try:
        trainer = make_trainer(k, backbone)
        trainer.build_model()
        feats, labels = step_inputs(trainer, k, b)
        trainer._train_step(feats, labels)  # the first call's allocations
        sync(trainer.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = trainer._train_step(feats, labels)
        sync(trainer.device)
        if not torch.isfinite(loss):
            raise RuntimeError(f"CoCoOp step at budget {budget}: loss {loss}")
        return (time.perf_counter() - t0) / steps * 1000
    finally:
        cocoop_mod.PROMPT_BUDGET = saved


def run(k: int = K, b: int = B, steps: int = STEPS,
        backbone: str = "ViT-B/16") -> dict:
    import clip_gp_tpu_torch.methods.cocoop as cocoop_mod
    from clip_gp_tpu_torch.core.device import device_label

    default_budget = int(cocoop_mod.PROMPT_BUDGET)
    with bench_context("bench_cocoop_"):
        ms_default = measure(default_budget, k, b, steps, backbone)
        ms_batched = measure(b * k, k, b, steps, backbone)
    return {
        f"cocoop_step_ms_default_budget{default_budget}": round(ms_default, 1),
        "cocoop_step_ms_fully_batched": round(ms_batched, 1),
        "batched_over_default_ratio": round(ms_batched / ms_default, 2),
        "shape": f"K={k} B={b} n_ctx={N_CTX} {backbone} text tower",
        "device": device_label(),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
