"""CoCoOp single-card step profile at the worst measured shape (K=100), the
JAX package's ``scripts/bench_cocoop_profile.py`` on the port.

Drives the trainer's own ``_train_step`` and ``conditional_logits`` (no
second copy of the math) and reports, per prompt-tower dtype (fp32, the
reference-parity default, and bf16: bf16 products with fp32 LayerNorm,
softmax and master parameters; ``CLIP_GP_TPU_TORCH_PROMPT_TOWER_DTYPE``,
read at call time):

- step_compile_s: the first ``_train_step`` call. Nothing compiles per
  shape on the card; the first call pays the kernel library's build or
  load at the first launch (``ops/_build.py``), the caching allocator's
  first allocations and cuDNN's first choice of algorithms (the image
  tower is not run here);
- step_ms: a warm train step (tower forward, recompute and backward through
  K1/K2 and K4/K3, and the meta-net/ctx update);
- fwd_ms: forward-only conditional logits at the train shape (so
  bwd_update_ms = step_ms − fwd_ms is the backward and update);
- eval_ms_per_1k_rows: forward logits over EVAL_ROWS rows, per 1,000.

Every window ends with ``torch.cuda.synchronize()``. The report also goes
to ``build/scripts/BENCH_cocoop_profile.json``. Knobs: ``BENCH_COCOOP_K``
(100), ``BENCH_COCOOP_B`` (32), ``BENCH_COCOOP_STEPS`` (10).

    python -m clip_gp_tpu_torch.scripts.bench_cocoop_profile
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from clip_gp_tpu_torch.scripts._common import (
    bench_context,
    sync,
    write_artifact,
)
from clip_gp_tpu_torch.scripts.bench_cocoop import make_trainer, step_inputs

K = int(os.environ.get("BENCH_COCOOP_K", "100"))
B = int(os.environ.get("BENCH_COCOOP_B", "32"))
STEPS = int(os.environ.get("BENCH_COCOOP_STEPS", "10"))
EVAL_ROWS = 512
DTYPE_ENV = "CLIP_GP_TPU_TORCH_PROMPT_TOWER_DTYPE"


def profile_dtype(dtype_name, k, b, steps, eval_rows, backbone):
    from clip_gp_tpu_torch.methods.cocoop import conditional_logits

    saved = os.environ.get(DTYPE_ENV)
    os.environ[DTYPE_ENV] = dtype_name
    try:
        trainer = make_trainer(k, backbone)
        trainer.build_model()
        device = trainer.device
        feats, labels = step_inputs(trainer, k, b)
        rng = np.random.default_rng(1)
        eval_feats = torch.from_numpy(rng.normal(
            size=(eval_rows, feats.shape[1])).astype(np.float32)).to(device)

        sync(device)
        t0 = time.perf_counter()
        loss, _ = trainer._train_step(feats, labels)
        sync(device)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = trainer._train_step(feats, labels)
        sync(device)
        step_ms = (time.perf_counter() - t0) / steps * 1000

        def fwd(f):
            with torch.no_grad():
                return conditional_logits(
                    trainer.clip_model, trainer.params, f, trainer.token_prefix,
                    trainer.token_suffix, trainer.eot, k, trainer.logit_scale)

        fwd(feats)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            fwd(feats)
        sync(device)
        fwd_ms = (time.perf_counter() - t0) / steps * 1000

        t0 = time.perf_counter()
        for lo in range(0, eval_rows, b):
            fwd(eval_feats[lo:lo + b])
        sync(device)
        eval_ms_per_1k = (time.perf_counter() - t0) / eval_rows * 1000 * 1000
    finally:
        if saved is None:
            os.environ.pop(DTYPE_ENV, None)
        else:
            os.environ[DTYPE_ENV] = saved
    return {
        "step_compile_s": round(compile_s, 1),
        "step_ms": round(step_ms, 1),
        "fwd_ms": round(fwd_ms, 1),
        "bwd_update_ms": round(step_ms - fwd_ms, 1),
        "eval_ms_per_1k_rows": round(eval_ms_per_1k, 1),
        "final_loss": float(loss),
    }


def run(k: int = K, b: int = B, steps: int = STEPS, eval_rows: int = EVAL_ROWS,
        backbone: str = "ViT-B/16") -> dict:
    from clip_gp_tpu_torch.core.device import device_label

    with bench_context("bench_cocoop_profile_"):
        out = {
            "shape": f"K={k} B={b} {backbone} text tower",
            "device": device_label(),
            "fp32": profile_dtype("float32", k, b, steps, eval_rows, backbone),
            "bf16": profile_dtype("bf16", k, b, steps, eval_rows, backbone),
        }
    out["bf16_step_speedup"] = round(
        out["fp32"]["step_ms"] / out["bf16"]["step_ms"], 2)
    write_artifact("BENCH_cocoop_profile.json", out)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
