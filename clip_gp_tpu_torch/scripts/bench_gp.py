"""GP-fit microbenchmark, the JAX package's ``scripts/bench_gp.py`` on the
port: the second BASELINE.md north-star metric ("GP fit + Cholesky
ms/dataset").

Measures, at flagship sizes (K=100 classes, M=8 templates, D=1024 RN50
features, PCA d=256, S=30 MC samples, N=1600 cached few-shot features):
  - one Adapter+GP train step (sample -> sparsemax -> MC-CE + KL + L2
    -> AdamW update), ms/step, the mean over 20 steps;
  - a full 100-epoch GP fit, seconds;
  - one S=300 MC evaluation over a 2465-image test set, ms.

The GP is plain PyTorch (``gp/svgp.py``): no hand-written kernel runs
here. The update is ``runtime/optim.py``'s ``StepAdamW`` with
``optax.adamw(1e-3)``'s defaults (weight decay 1e-4, where
``torch.optim.AdamW`` defaults to 1e-2). One step runs before any timed
window (the first call's allocations); each window ends with
``torch.cuda.synchronize()``.

    python -m clip_gp_tpu_torch.scripts.bench_gp
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np
import torch

from clip_gp_tpu_torch.scripts._common import sync

K, M, D = 100, 8, 1024
N_TRAIN, N_TEST = 1600, 2465
S_TRAIN, S_EVAL = 30, 300
EPOCHS = 100
TIMED_STEPS = 20
PCA_DIM = 256


def run(k: int = K, m: int = M, d: int = D, n_train: int = N_TRAIN,
        n_test: int = N_TEST, s_train: int = S_TRAIN, s_eval: int = S_EVAL,
        epochs: int = EPOCHS, timed_steps: int = TIMED_STEPS,
        pca_dim: int = PCA_DIM, device=None) -> dict:
    from clip_gp_tpu_torch.core.device import device_label, resolve_device
    from clip_gp_tpu_torch.gp import svgp
    from clip_gp_tpu_torch.methods import common
    from clip_gp_tpu_torch.runtime.optim import StepAdamW

    device = resolve_device(device)
    cfg = types.SimpleNamespace(adapter=types.SimpleNamespace(
        gp_pca_dim=pca_dim, gp_kernel_type="rbf", gp_prior_temp=1.0,
        gp_jitter=1e-4,
    ))
    rng = np.random.default_rng(0)
    e = rng.normal(size=(k, m, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    static, gp_params, buffers = svgp.create_gp(e, cfg, device)
    eye = torch.eye(d, device=device)
    full = {"visual_proj": eye.clone(), "gp": gp_params}
    leaves = [full["visual_proj"], *gp_params.values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    feats = torch.from_numpy(rng.normal(size=(n_train, d)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, k, size=n_train)).to(device)
    test_feats = torch.from_numpy(
        rng.normal(size=(n_test, d)).astype(np.float32)).to(device)
    opt = StepAdamW(leaves, lambda _: 1e-3, weight_decay=1e-4)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        projected = feats @ full["visual_proj"].T
        f_norm = common.l2_normalize(projected)
        protos, _ = svgp.sample_prototypes(static, full["gp"], buffers, s_train,
                                           generator=gen)
        ce = common.mc_cross_entropy(f_norm, protos, labels, 100.0)
        kl = svgp.kl_divergence(full["gp"]).sum()
        l2 = ((full["visual_proj"] - eye) ** 2).sum()
        loss = ce + 0.01 * kl + 0.125 * l2
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    def evaluate():
        with torch.no_grad():
            protos, _ = svgp.sample_prototypes(static, full["gp"], buffers,
                                               s_eval, generator=gen)
            projected = test_feats @ full["visual_proj"].T
            return common.cosine_logits(projected, protos, 100.0)

    step()  # the first call's allocations
    evaluate()
    sync(device)

    t0 = time.perf_counter()
    for _ in range(timed_steps):
        loss = step()
    sync(device)
    step_ms = (time.perf_counter() - t0) / timed_steps * 1000

    t0 = time.perf_counter()
    for _ in range(epochs):
        loss = step()
    sync(device)
    fit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = evaluate()
    sync(device)
    eval_ms = (time.perf_counter() - t0) * 1000
    if not (torch.isfinite(loss) and torch.isfinite(out).all()):
        raise RuntimeError("bench_gp: non-finite loss or logits")
    return {
        "gp_train_step_ms": round(step_ms, 2),
        f"gp_fit_{epochs}_epochs_s": round(fit_s, 2),
        f"gp_mc_eval_s{s_eval}_ms": round(eval_ms, 1),
        "shape": f"K={k} M={m} D={d} d={pca_dim} S={s_train}/{s_eval} N={n_train}",
        "final_loss": float(loss),
        "device": device_label(device),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
