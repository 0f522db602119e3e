"""Differentiated text-tower benchmark: the port's kernels (K1/K2 forward,
K4/K3 backward) against a tower composed from library calls, the JAX
package's ``scripts/bench_fused_vjp.py`` on the port.

CoOp and CoCoOp differentiate through the text tower every training step.
This bench times the program a trial-batched CoOp group runs: the gradient
of a cosine cross-entropy, summed over T trials, with respect to each
trial's context, the text features of all T·K prompts (77 tokens) coming
from one text-tower call. Two modes:

- ``kernels``: ``CLIP.text_features_from_embeddings``, every block K1 then
  K2 forward and K4 then K3 backward (``ops/flash_attention.py``);
- ``library``: the same tower composed here from ``F.layer_norm``,
  ``F.linear`` and ``F.scaled_dot_product_attention``, differentiated by
  autograd — the yardstick the smoke times K1–K4 against. It lives in this
  script only; the package has no switch to it.

The JAX script's third mode, ``xla`` (Pallas forward, XLA-math VJP), has no
counterpart: the port has no backward but K3/K4 (``ops/flash_attention.py``
raises rather than fall back), and the report says so.

Protocol: each mode's first step runs before any timing; then REPS rounds,
the modes in turn within each round, each round STEPS chained steps (each
step's context updated from the previous step's gradient) between two
``torch.cuda.synchronize()``; the least per mode counts. Both modes' loss
and context gradient at the initial context are compared
(``grad_max_rel_err``: the largest difference over the largest gradient).
Knobs: ``BENCH_VJP_TRIALS`` (5), ``BENCH_VJP_CLASSES`` (100),
``BENCH_VJP_NCTX`` (16), ``BENCH_VJP_STEPS`` (20), ``BENCH_VJP_REPS`` (3),
``BENCH_VJP_BACKBONE`` (ViT-B/16).

    python -m clip_gp_tpu_torch.scripts.bench_fused_vjp
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from clip_gp_tpu_torch.scripts._common import sync

T_TRIALS = int(os.environ.get("BENCH_VJP_TRIALS", "5"))
CLASSES = int(os.environ.get("BENCH_VJP_CLASSES", "100"))
N_CTX = int(os.environ.get("BENCH_VJP_NCTX", "16"))
STEPS = int(os.environ.get("BENCH_VJP_STEPS", "20"))
REPS = int(os.environ.get("BENCH_VJP_REPS", "3"))
BACKBONE = os.environ.get("BENCH_VJP_BACKBONE", "ViT-B/16")
BATCH = 32
CONTEXT = 77


def library_tower(model):
    """``text_features_from_embeddings`` of ``model`` (fp32) composed from
    library calls: (token embeds [B, L, W], eot [B]) → [B, embed_dim]."""
    from clip_gp_tpu_torch.models.clip_model import causal_mask

    blocks = [
        (blk.heads, blk.ln_1, blk.attn.w_qkv.T.contiguous(), blk.attn.b_qkv,
         blk.attn.w_out.T.contiguous(), blk.attn.b_out, blk.ln_2,
         blk.mlp.c_fc.w.T.contiguous(), blk.mlp.c_fc.b,
         blk.mlp.c_proj.w.T.contiguous(), blk.mlp.c_proj.b)
        for blk in model.transformer.blocks
    ]

    def tower(x, eot):
        b, n, d = x.shape
        x = x + model.pos_embed[:n]
        mask = causal_mask(n, x.device)
        for heads, ln1, wqkv, bqkv, wout, bout, ln2, wfc, bfc, wproj, bproj in blocks:
            h = F.layer_norm(x, (d,), ln1.scale, ln1.bias)
            q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2)
                       for t in F.linear(h, wqkv, bqkv).split(d, -1))
            a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            x = x + F.linear(a.transpose(1, 2).reshape(b, n, d), wout, bout)
            h = F.linear(F.layer_norm(x, (d,), ln2.scale, ln2.bias), wfc, bfc)
            x = x + F.linear(h * torch.sigmoid(1.702 * h), wproj, bproj)
        x = F.layer_norm(x, (d,), model.ln_final.scale, model.ln_final.bias)
        return x[torch.arange(b, device=x.device), eot] @ model.text_projection

    return tower


def run(t: int = T_TRIALS, k: int = CLASSES, n_ctx: int = N_CTX,
        steps: int = STEPS, reps: int = REPS, backbone: str = BACKBONE,
        batch: int = BATCH, context: int = CONTEXT) -> dict:
    from clip_gp_tpu_torch.core.config import Config
    from clip_gp_tpu_torch.core.device import device_label, resolve_device
    from clip_gp_tpu_torch.methods import common
    from clip_gp_tpu_torch.models.clip_loader import load_clip_resolved

    device = resolve_device()
    cfg = Config()
    cfg.model.backbone_name = backbone
    arch, model, _ = load_clip_resolved(cfg, allow_random=True, seed=0,
                                        device=device)
    w, d_embed = int(arch.transformer_width), int(arch.embed_dim)
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    # CoOpSpec-shaped inputs: per-trial ctx [T, n_ctx, W]; shared prefix
    # [K, 1, W] and suffix [K, L-1-n_ctx, W]; frozen image features [T, B, D]
    ctx0 = tensor(0.02 * rng.normal(size=(t, n_ctx, w)))
    prefix = tensor(0.02 * rng.normal(size=(k, 1, w)))
    suffix = tensor(0.02 * rng.normal(size=(k, context - 1 - n_ctx, w)))
    eot = torch.from_numpy(rng.integers(5, context - 7, size=(k,))).to(device)
    feats = common.l2_normalize(tensor(rng.normal(size=(t, batch, d_embed))))
    labels = torch.from_numpy(rng.integers(0, k, size=(t, batch))).to(device)
    eot_tk = eot.repeat(t)

    def make_step(tower):
        def loss_grad(ctx):
            ctx = ctx.detach().requires_grad_(True)
            prompts = torch.cat([
                prefix.expand(t, k, 1, w),
                ctx[:, None].expand(t, k, n_ctx, w),
                suffix.expand(t, k, *suffix.shape[1:]),
            ], dim=2).reshape(t * k, context, w)
            text = common.l2_normalize(tower(prompts, eot_tk).reshape(t, k, -1))
            logits = 100.0 * torch.einsum("tbd,tkd->tbk", feats, text)
            loss = sum(common.cross_entropy(logits[i], labels[i]) for i in range(t))
            (grad,) = torch.autograd.grad(loss, ctx)
            return loss.detach(), grad

        def step(ctx):
            loss, grad = loss_grad(ctx)
            return ctx - 0.01 * grad, loss

        return loss_grad, step

    modes = {
        "kernels": make_step(model.text_features_from_embeddings),
        "library": make_step(library_tower(model)),
    }
    first = {mode: fns[0](ctx0) for mode, fns in modes.items()}
    (loss_k, grad_k), (loss_l, grad_l) = first["kernels"], first["library"]
    grad_err = float((grad_k - grad_l).abs().max() / grad_l.abs().max())

    results = {mode: float("inf") for mode in modes}
    for rep in range(reps):
        for mode, (_, step) in modes.items():
            ctx, loss = step(ctx0)
            sync(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                ctx, loss = step(ctx)
            final = float(ctx.sum()) + float(loss)
            dt = (time.perf_counter() - t0) / steps
            results[mode] = min(results[mode], dt)
            print(f"# rep={rep} mode={mode}: {dt * 1000:.1f} ms/step "
                  f"(final={final:.4f})", file=sys.stderr)

    return {
        "metric": "coop_group_train_step_ms",
        "backbone": backbone,
        "trials": t, "classes": k, "n_ctx": n_ctx, "batch": batch,
        "prompts_per_step": t * k,
        "kernels_ms": round(results["kernels"] * 1000, 1),
        "library_ms": round(results["library"] * 1000, 1),
        "speedup_vs_library": round(results["library"] / results["kernels"], 3),
        "xla_vjp_ms": None,
        "xla_vjp_note": "not ported: the JAX package's XLA-math VJP beside a "
                        "Pallas forward has no counterpart; the port's only "
                        "backward of a block is K3/K4",
        "loss_kernels": float(loss_k),
        "loss_library": float(loss_l),
        "grad_max_rel_err": grad_err,
        "protocol": f"min over {reps} interleaved reps of {steps} chained "
                    "steps per mode",
        "device": device_label(device),
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
