#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clip_gp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc). Without a GPU, or without the package beside it, it
exits non-zero before printing any result. Phases, each raising on failure:

1. build: compiles the hand-written kernels (clip_gp_tpu_torch/csrc) and
   prints the build time, the card (``nvidia-smi`` name and power limit) and
   which optional host packages (PIL, yaml, regex) import;
2. kernels: K1 (fused LN-attention block) and K2 (fused LN-MLP block)
   against their plain PyTorch versions at the main path's shapes — ViT-B/16
   (B=32 and the training path's device batch B=512, N=197, D=768, H=12) and
   the text tower (B=256, N=77, D=512, H=8, causal) — in fp32 and bf16; K3
   and K4 (their backward kernels) at the prompt learners' shapes — the
   trimmed text tower (N=24, D=512, H=8, causal) at B=100 (a CoOp step on
   100 classes) and B=256 (a CoCoOp chunk at PROMPT_BUDGET), fp32, and B=256
   with a bf16 x — each asked for dx only (what the prompt learners launch)
   and for all seven gradients. Each cell reports the error against the
   stated tolerance and CUDA-event times (median of 20 after warm-up) of the
   kernel (``kernel_ms``; ``ms`` in the JSON line carries the same number),
   the plain version and a library yardstick, beside the least time the
   card could take (``bound_ms``);
3. towers: a ViT-B/16 ``encode_image`` (fp32, 32 images at 224) and an
   ``encode_text`` (256 prompts) with random weights, and the gradient of a
   CoOp-shaped loss with respect to 100 prompts' embeddings (N=24) through
   the text tower, each through the kernels and through the plain versions,
   compared;
4. trainer: the Adapter + GP flow of ``train.py --use-gp`` on ViT-B/16
   (``build_trainer(config, dm)`` → ``trainer.train()``) over an in-memory
   synthetic dataset, checking metrics.json and that every frozen encode
   launched K1 and K2;
5. CoOp: ``Adapter-CoOp`` on ViT-B/16 over 100 synthetic classes (4 shots,
   n_ctx 16, batch 32, 2 epochs), checking metrics.json, that the context
   moved, and that every step launched K1-K4 in each of the 12 blocks;
6. CoCoOp: ``Adapter-CoCoOp`` on the same 100 classes (1 shot, 1 epoch),
   the same checks, K1/K2 counted twice per block and chunk (the forward
   and its recompute under ``torch.utils.checkpoint``);
7. output: one ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Each of phases 4-6 sets the launch counts to 0 just before it runs and
reads them just after; a kernel's ``launches`` in the JSON line is the sum
over those three runs, and ``launches_by_path`` gives each.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

# Published dense peaks (NVIDIA data sheet, H100 SXM at 700 W): FLOP/s for
# fp32 on the CUDA cores and bf16 on the tensor cores, and memory bytes/s.
PEAKS = {
    "H100": {"fp32": 67e12, "bf16": 989e12, "bytes": 3.35e12},
}

# kernel → (source, TPU kernel replaced)
CSRC = "clip_gp_tpu_torch/csrc/"
KERNELS = {
    "fused_ln_attention_block": (
        f"{CSRC}ln_gemm.cu + {CSRC}attention.cu",
        "clip_gp_tpu/ops/flash_attention.py:845",
    ),
    "fused_ln_mlp": (
        f"{CSRC}ln_gemm.cu",
        "clip_gp_tpu/ops/flash_attention.py:329",
    ),
    "ln_attn_bwd": (
        f"{CSRC}gemm_bwd.cu + {CSRC}attention_bwd.cu + {CSRC}ln_bwd.cu "
        f"+ {CSRC}ln_gemm.cu (ln_stats)",
        "clip_gp_tpu/ops/flash_attention.py:668",
    ),
    "ln_mlp_bwd": (
        f"{CSRC}gemm_bwd.cu + {CSRC}ln_bwd.cu + {CSRC}ln_gemm.cu (ln_stats)",
        "clip_gp_tpu/ops/flash_attention.py:476",
    ),
}

# (name, batch, tokens, width, heads, causal): the main path's two towers —
# ViT-B/16 at 32 images and at the image-encode device batch of the training
# path (methods/common.py EXTRACT_DEVICE_BATCH), the text tower at the
# template-encode batch (encode_templates' batch_size)
SHAPES = [
    ("vit-b16", 32, 197, 768, 12, False),
    ("vit-b16", 512, 197, 768, 12, False),
    ("text", 256, 77, 512, 8, True),
]

# Kernel vs plain tolerances, elementwise |kernel - plain| <= atol + rtol*|plain|.
# fp32: both sum the same fp32 products in different orders; a K-term fp32
# dot (K up to 3072) drifts by ~sqrt(K)*2^-24 of its magnitude, ~1e-5 here.
# bf16: values are rounded to bf16 (8 significant bits) at the same points on
# both sides, so a different summation order can flip one rounding: one bf16
# ulp, at most 2^-7 of the value, plus 2^-6 absolute for values near zero.
TOLERANCES = {"fp32": (1e-4, 1e-4), "bf16": (2.0**-6, 2.0**-7)}
# (name, batch, tokens, width, heads, x dtype) of the backward cells: the
# trimmed text tower of the prompt learners (n_ctx 16 + a class name covers
# 24 positions), a CoOp step on 100 classes and a CoCoOp chunk of 256 prompts
BWD_SHAPES = [
    ("coop", 100, 24, 512, 8, "fp32"),
    ("cocoop", 256, 24, 512, 8, "fp32"),
    ("cocoop", 256, 24, 512, 8, "bf16"),
]
# K3/K4 kernel vs plain: both recompute the block in fp32 and sum up to
# T = B·N rows of fp32 products into each weight gradient, in other orders;
# the error scales with the gradient's largest value. Allowed, elementwise:
# 1e-4 x (max |plain| + |plain|), or one bf16 ulp of that for a gradient
# that comes out in bf16 (dx of a bf16 x).
BWD_RTOL = {"fp32": 1e-4, "bf16": 2.0**-7}
# encoded features after 12 (or 12 text) layers, kernels vs plain, fp32:
# the fp32 per-block drift above (~1e-5 of the values) compounds over 12
# blocks; allowed: 1e-4 of the largest feature
TOWER_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}: add them to PEAKS")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(out, ref, atol: float, rtol: float):
    """(max abs error, max error relative to atol + |ref|, within tolerance)."""
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    max_rel = (diff / (atol + ref.float().abs())).max().item()
    return diff.max().item(), max_rel, bool((diff <= limit).all().item())


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build():
    import torch

    from clip_gp_tpu_torch.core.device import resolve_device
    from clip_gp_tpu_torch.ops import _build

    device = resolve_device("cuda")
    start = time.perf_counter()
    _build.library()
    log(f"[build] kernels built in {time.perf_counter() - start:.2f} s "
        f"({_build.BUILD_DIR})")
    if not _build.last_build["cached"]:
        # nvcc's -Xptxas -v output, one "== <source>" section per file
        for section in _build.last_build["ptxas"].split("== ")[1:]:
            source, _, ptxas = section.partition("\n")
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
            spills = [int(s) for s in re.findall(r"(\d+) bytes spill", ptxas)]
            log(f"[build] ptxas {source}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers a thread, {sum(spills)} bytes of spills")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    for mod in ("PIL", "yaml", "regex"):
        try:
            __import__(mod)
            log(f"[build] import {mod}: ok")
        except ImportError:
            log(f"[build] import {mod}: missing")
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return device, smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _block_inputs(b, n, d, causal, dtype, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    p = {
        "x": rnd(b, n, d).to(dtype),
        "ln_scale": 1 + 0.1 * rnd(d), "ln_bias": 0.1 * rnd(d),
        "w_qkv": rnd(d, 3 * d, scale=d**-0.5).to(dtype),
        "b_qkv": (0.1 * rnd(3 * d)).to(dtype),
        "w_out": rnd(d, d, scale=d**-0.5).to(dtype),
        "b_out": (0.1 * rnd(d)).to(dtype),
        "w_fc": rnd(d, 4 * d, scale=d**-0.5).to(dtype), "b_fc": 0.1 * rnd(4 * d),
        "w_proj": rnd(4 * d, d, scale=(4 * d) ** -0.5).to(dtype),
        "b_proj": 0.1 * rnd(d),
    }
    p["mask"] = (
        torch.triu(torch.full((n, n), float("-inf"), device=device), 1)
        if causal else None
    )
    return p


def _k1_library(p, heads):
    """LN + qkv + attention + out-projection + residual from library calls."""
    import torch.nn.functional as F

    x = p["x"]
    b, n, d = x.shape
    w_qkv_t, w_out_t = p["w_qkv_t"], p["w_out_t"]
    h = F.layer_norm(x, (d,), p["ln_scale"].to(x.dtype), p["ln_bias"].to(x.dtype))
    qkv = F.linear(h, w_qkv_t, p["b_qkv"])
    q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2) for t in qkv.split(d, -1))
    mask = None if p["mask"] is None else p["mask"].to(x.dtype)
    attn = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return x + F.linear(attn.transpose(1, 2).reshape(b, n, d), w_out_t,
                        p["b_out"])


def _k2_library(p):
    import torch
    import torch.nn.functional as F

    x = p["x"]
    d = x.shape[-1]
    h = F.layer_norm(x, (d,), p["ln_scale"].to(x.dtype), p["ln_bias"].to(x.dtype))
    hid = F.linear(h, p["w_fc_t"], p["b_fc"].to(x.dtype))
    hid = hid * torch.sigmoid(1.702 * hid)
    return x + F.linear(hid, p["w_proj_t"], p["b_proj"].to(x.dtype))


def _cost(kernel, b, n, d, itemsize, masked):
    """(FLOPs, bytes) the block must do and move: each input read once and
    the output written once."""
    t = b * n
    act = 2 * t * d * itemsize  # x in, out
    if kernel == "fused_ln_attention_block":
        flops = 8 * t * d * d + 4 * b * n * n * d
        weights = 4 * d * d * itemsize + (3 * d + d) * itemsize + 2 * d * 4
        return flops, act + weights + (n * n * 4 if masked else 0)
    flops = 16 * t * d * d
    weights = 8 * d * d * itemsize + (4 * d + d) * 4 + 2 * d * 4
    return flops, act + weights


def phase_kernels(device, peaks):
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    cells = []
    for shape_name, b, n, d, heads, causal in SHAPES:
        for dtype_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            p = _block_inputs(b, n, d, causal, dtype, device, seed=len(cells))
            for key in ("w_qkv", "w_out", "w_fc", "w_proj"):
                p[key + "_t"] = p[key].t().contiguous()  # F.linear layout
            runs = {
                "fused_ln_attention_block": (
                    lambda: fa.fused_ln_attention_block(
                        p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"],
                        p["b_qkv"], p["w_out"], p["b_out"], heads, p["mask"]),
                    lambda: fa.ln_attention_block_plain(
                        p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"],
                        p["b_qkv"], p["w_out"], p["b_out"], heads, p["mask"]),
                    lambda: _k1_library(p, heads),
                ),
                "fused_ln_mlp": (
                    lambda: fa.fused_ln_mlp(
                        p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"],
                        p["b_fc"], p["w_proj"], p["b_proj"]),
                    lambda: fa.ln_mlp_plain(
                        p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"],
                        p["b_fc"], p["w_proj"], p["b_proj"]),
                    lambda: _k2_library(p),
                ),
            }
            atol, rtol = TOLERANCES[dtype_name]
            for kernel, (run_kernel, run_plain, run_library) in runs.items():
                with torch.no_grad():
                    out = run_kernel()
                    ref = run_plain()
                    torch.cuda.synchronize()
                    max_abs, max_rel, ok = compare(out, ref, atol, rtol)
                    if not bool(torch.isfinite(out).all()):
                        raise RuntimeError(f"{kernel} {shape_name} {dtype_name}: "
                                           "non-finite output")
                    ms = time_ms(run_kernel)
                    plain_ms = time_ms(run_plain)
                    library_ms = time_ms(run_library)
                flops, nbytes = _cost(kernel, b, n, d, p["x"].element_size(),
                                      causal)
                t_ops = flops / peaks[dtype_name] * 1e3
                t_bytes = nbytes / peaks["bytes"] * 1e3
                cell = {
                    "name": f"{kernel}[{shape_name},B={b},{dtype_name}]",
                    "kernel": kernel,
                    "route": "cuda",
                    "source": KERNELS[kernel][0],
                    "replaces": KERNELS[kernel][1],
                    "shape": [b, n, d, heads],
                    "dtype": dtype_name,
                    "max_abs_err": max_abs,
                    "max_rel_err": max_rel,
                    "tol": {"atol": atol, "rtol": rtol},
                    "kernel_ms": ms,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                }
                log(f"[kernels] {cell['name']}: max_abs_err {max_abs:.3e} "
                    f"max_rel_err {max_rel:.3e} (tol atol {atol:.3e} rtol "
                    f"{rtol:.3e}) kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                    f"library_ms {library_ms:.4f} bound_ms "
                    f"{cell['bound_ms']:.4f} ({cell['bound_by']})")
                if not ok:
                    raise RuntimeError(f"{cell['name']}: kernel disagrees with "
                                       "its plain version past the tolerance")
                cells.append(cell)
            del p, runs
    return cells


def _bwd_cost(kernel, b, n, d, itemsize, param_grads):
    """(FLOPs, bytes) of one backward call: x and dout read once, the
    weights once, dx (and with ``param_grads`` every parameter gradient)
    written once. The math is fp32 whatever x's type."""
    t = b * n
    act = 3 * t * d * itemsize  # x, dout in; dx out
    if kernel == "ln_attn_bwd":
        flops = (22 if param_grads else 14) * t * d * d + 12 * b * n * n * d
        params = 4 * d * d * itemsize + 3 * d * itemsize + 2 * d * 4
        extra = n * n * 4  # the mask
        grads = params + d * 4  # ... and db_out, fp32
    else:
        flops = (40 if param_grads else 24) * t * d * d
        params = 8 * d * d * itemsize + 4 * d * 4 + 2 * d * 4
        extra = 0
        grads = params + d * 4  # ... and db_proj, fp32
    return flops, act + params + extra + (grads if param_grads else 0)


def _compare_grads(got, ref):
    """(max abs error, max error relative to max|ref| + |ref|, every error
    within BWD_RTOL of that) over the gradients compared."""
    import torch

    max_abs = max_rel = 0.0
    ok = True
    for out, expected in zip(got, ref):
        rtol = BWD_RTOL["bf16" if out.dtype == torch.bfloat16 else "fp32"]
        out, expected = out.float(), expected.float()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("non-finite gradient")
        diff = (out - expected).abs()
        limit = (expected.abs().max() + expected.abs()).clamp_min(1e-30)
        max_abs = max(max_abs, diff.max().item())
        max_rel = max(max_rel, (diff / limit).max().item())
        ok = ok and bool((diff <= rtol * limit).all())
    return max_abs, max_rel, ok


def _bwd_library(kernel, p, heads, param_grads):
    """The block's forward from library calls, recorded by autograd once;
    returns a function that runs only its backward (the yardstick: PyTorch
    keeps the forward's activations, the kernels recompute them)."""
    import torch

    names = (["x", "ln_scale", "ln_bias", "w_qkv_t", "b_qkv", "w_out_t", "b_out"]
             if kernel == "ln_attn_bwd" else
             ["x", "ln_scale", "ln_bias", "w_fc_t", "b_fc", "w_proj_t", "b_proj"])
    q = dict(p)
    leaves = []
    for name in names if param_grads else ["x"]:
        q[name] = p[name].detach().clone().requires_grad_(True)
        leaves.append(q[name])
    with torch.enable_grad():
        out = _k1_library(q, heads) if kernel == "ln_attn_bwd" else _k2_library(q)
    dout = p["dout"]
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def phase_bwd_kernels(device, peaks):
    """K3/K4 cells: kernel vs plain on all seven gradients, timed dx-only
    and with every gradient."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    cells = []
    for shape_name, b, n, d, heads, dtype_name in BWD_SHAPES:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
        p = _block_inputs(b, n, d, True, dtype, device, seed=100 + len(cells))
        p["dout"] = torch.randn(b, n, d, generator=torch.Generator().manual_seed(
            len(cells))).to(device, dtype)
        for key in ("w_qkv", "w_out", "w_fc", "w_proj"):
            p[key + "_t"] = p[key].t().contiguous()
        args = {
            "ln_attn_bwd": (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"],
                            p["b_qkv"], p["w_out"], p["mask"], heads, p["dout"]),
            "ln_mlp_bwd": (p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"],
                           p["b_fc"], p["w_proj"], p["dout"]),
        }
        plain = {"ln_attn_bwd": fa.ln_attn_bwd_plain, "ln_mlp_bwd": fa.ln_mlp_bwd_plain}
        for kernel in ("ln_attn_bwd", "ln_mlp_bwd"):
            a = args[kernel]
            run_plain = lambda: plain[kernel](*a)  # noqa: E731
            ref = run_plain()
            plain_ms = time_ms(run_plain)
            for param_grads in (False, True):
                run_kernel = lambda: getattr(fa, kernel)(  # noqa: E731
                    *a, param_grads=param_grads)
                got = run_kernel()
                torch.cuda.synchronize()
                max_abs, max_rel, ok = _compare_grads(
                    got if param_grads else got[:1], ref)
                ms = time_ms(run_kernel)
                library_ms = time_ms(_bwd_library(kernel, p, heads, param_grads))
                flops, nbytes = _bwd_cost(kernel, b, n, d, p["x"].element_size(),
                                          param_grads)
                t_ops = flops / peaks["fp32"] * 1e3
                t_bytes = nbytes / peaks["bytes"] * 1e3
                grads = "all" if param_grads else "dx"
                cell = {
                    "name": f"{kernel}[text-{shape_name},B={b},N={n},{dtype_name},"
                            f"{grads}]",
                    "kernel": kernel,
                    "route": "cuda",
                    "source": KERNELS[kernel][0],
                    "replaces": KERNELS[kernel][1],
                    "shape": [b, n, d, heads],
                    "dtype": dtype_name,
                    "grads": grads,
                    "max_abs_err": max_abs,
                    "max_rel_err": max_rel,
                    "tol": {"of_max_plus_abs": BWD_RTOL},
                    "kernel_ms": ms,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                }
                log(f"[kernels] {cell['name']}: max_abs_err {max_abs:.3e} "
                    f"max_rel_err {max_rel:.3e} (tol {BWD_RTOL} x (max|plain| + "
                    f"|plain|)) kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                    f"library_ms {library_ms:.4f} bound_ms {cell['bound_ms']:.4f} "
                    f"({cell['bound_by']})")
                if not ok:
                    raise RuntimeError(f"{cell['name']}: kernel disagrees with "
                                       "its plain version past the tolerance")
                cells.append(cell)
        del p, args
    return cells


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_towers(device, backbone="ViT-B/16", n_images=32, n_prompts=256):
    import torch

    from clip_gp_tpu_torch.data.template_banks import IMAGENET_TEMPLATES
    from clip_gp_tpu_torch.models import clip_model
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params
    from clip_gp_tpu_torch.models.tokenizer import tokenize
    from clip_gp_tpu_torch.ops import flash_attention as fa

    arch = clip_model.ARCHITECTURES[backbone]
    model = init_clip_params(arch, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    res = arch.image_resolution
    images = torch.randn(n_images, res, res, 3, generator=g).to(device)
    names = ["red circle", "green square", "blue stripe", "yellow dot"]
    prompts = [t.format(c) for c in names for t in IMAGENET_TEMPLATES][:n_prompts]
    tokens = torch.from_numpy(tokenize(prompts)).to(device)

    def encode():
        with torch.no_grad():
            return model.encode_image(images), model.encode_text(tokens)

    img_k, txt_k = encode()
    # the same towers with every block on the plain versions
    with mock.patch.object(clip_model, "fused_ln_attention_block",
                           fa.ln_attention_block_plain), \
            mock.patch.object(clip_model, "fused_ln_mlp", fa.ln_mlp_plain):
        img_p, txt_p = encode()
    torch.cuda.synchronize()
    for what, out, ref, shape in (
        ("encode_image", img_k, img_p, (n_images, arch.embed_dim)),
        ("encode_text", txt_k, txt_p, (len(prompts), arch.embed_dim)),
    ):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{what}: bad output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        log(f"[towers] {backbone} {what} {tuple(out.shape)} fp32: kernels vs "
            f"plain max_abs_err {err:.3e} (max |feature| {scale:.3f}; tol "
            f"{TOWER_TOL:.1e} x max |feature|)")
        if err > TOWER_TOL * scale:
            raise RuntimeError(f"{what}: kernel tower disagrees with the plain one")
    _tower_grad(model, device)
    del model


def _tower_grad(model, device, n_prompts=100, n=24, n_images=32):
    """The gradient of a CoOp-shaped loss (cross-entropy of 100 x cosine
    logits) with respect to the prompt embeddings, through K1-K4 and
    through every block's plain forward and plain backward, compared."""
    import torch
    import torch.nn.functional as F

    from clip_gp_tpu_torch.ops import flash_attention as fa

    arch = model.arch
    g = torch.Generator().manual_seed(2)
    embeds = (0.02 * torch.randn(n_prompts, n, arch.transformer_width,
                                 generator=g)).to(device)
    eot = torch.randint(8, n, (n_prompts,), generator=g).to(device)
    img = F.normalize(torch.randn(n_images, arch.embed_dim, generator=g), dim=-1)
    img = img.to(device)
    labels = torch.randint(0, n_prompts, (n_images,), generator=g).to(device)

    def grad():
        e = embeds.clone().requires_grad_(True)
        text = F.normalize(model.text_features_from_embeddings(e, eot), dim=-1)
        loss = F.cross_entropy(100.0 * img @ text.T, labels)
        return torch.autograd.grad(loss, e)[0]

    fa.reset_launch_counts()
    got = grad()
    launches = dict(fa.LAUNCHES)
    with mock.patch.object(fa, "_ln_attention_forward", fa.ln_attention_block_plain), \
            mock.patch.object(fa, "_ln_mlp_forward", fa.ln_mlp_plain), \
            mock.patch.object(fa, "ln_attn_bwd",
                              lambda *a, param_grads: fa.ln_attn_bwd_plain(*a)), \
            mock.patch.object(fa, "ln_mlp_bwd",
                              lambda *a, param_grads: fa.ln_mlp_bwd_plain(*a)):
        ref = grad()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("tower gradient: non-finite values")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"[towers] {arch.name} text-tower grad d(loss)/d(embeds) "
        f"{tuple(got.shape)} fp32: kernels vs plain max_abs_err {err:.3e} (max "
        f"|grad| {scale:.3e}; tol {TOWER_TOL:.1e} x max |grad|); launches "
        f"{launches}")
    if err > TOWER_TOL * scale:
        raise RuntimeError("tower gradient: kernels disagree with the plain versions")
    layers = arch.transformer_layers
    if min(launches.values()) < layers:
        raise RuntimeError(f"tower gradient: expected each kernel {layers} times, "
                           f"got {launches}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

class _ArrayLoader:
    """Batches of in-memory uint8 images, as BatchLoader yields them."""

    def __init__(self, images, labels, batch_size):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.data_source = list(range(len(labels)))

    def __len__(self):
        return math.ceil(len(self.labels) / self.batch_size)

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            yield {"img": self.images[i:i + self.batch_size],
                   "label": self.labels[i:i + self.batch_size]}


class InMemoryDataManager:
    """The synthetic dataset's numpy images (``num_classes`` classes, "pattern
    c" past the first four) at full resolution, split per class into
    ``shots`` train images and the rest test, with no transform
    (INPUT.TRANSFORMS has no augmentation, so the test transform of a
    decoded image at the input size is the identity)."""

    def __init__(self, config, images_per_class, num_classes=4):
        import numpy as np

        from clip_gp_tpu_torch.data.datasets.synthetic import (
            synthetic_class_name,
            synthetic_images,
        )
        from clip_gp_tpu_torch.data.datum import DatasetBase, Datum

        shots = config.dataset.num_shots
        size = config.input.size[0]
        train, test = ([], []), ([], [])
        items = {"train": [], "test": []}
        for c, i, img in synthetic_images(num_classes, images_per_class, size,
                                          config.seed):
            split, arrays = ("train", train) if i < shots else ("test", test)
            arrays[0].append(img)
            arrays[1].append(c)
            items[split].append(Datum(f"synthetic/{c}/{i}", c, classname=synthetic_class_name(c)))
        self.dataset = DatasetBase(train_x=items["train"], test=items["test"])
        bs = config.dataloader.batch_size_train
        self.train_images = np.stack(train[0])
        self.train_labels = np.asarray(train[1], np.int32)
        self.train_loader_x = _ArrayLoader(self.train_images, self.train_labels, bs)
        self.test_loader = _ArrayLoader(np.stack(test[0]), np.asarray(test[1], np.int32),
                                        config.dataloader.batch_size_test)
        self.val_loader = None
        self.num_classes = self.dataset.num_classes
        self.lab2cname = self.dataset.lab2cname

    def eval_train_loader(self):
        return self.train_loader_x


def _config(backbone, trainer_name, shots, epochs):
    from clip_gp_tpu_torch.core.config import Config
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    c = Config()
    c.trainer_name = trainer_name
    c.dataset.name = "Synthetic"
    c.dataset.num_shots = shots
    arch = ARCHITECTURES[backbone]
    c.model.backbone_name = backbone
    c.input.size = (arch.image_resolution, arch.image_resolution)
    c.input.transforms = ["normalize"]
    c.dataloader.batch_size_train = 32
    c.dataloader.batch_size_test = 32
    c.adapter.clip_adapter_epochs = epochs
    c.optim.max_epoch = epochs
    c.train.print_freq = 1
    c.seed = 1
    return c, arch


def _train(c, dm, on_build=None):
    """``build_trainer(c, dm).train()`` with the launch counts set to 0 just
    before and read just after: (launches, metrics, seconds, trainer).
    ``on_build`` sees the trainer right after its ``build_model``."""
    import numpy as np
    import torch

    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    import clip_gp_tpu_torch.methods  # noqa: F401  (registers the trainers)
    from clip_gp_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        c.output_dir = out_dir
        set_random_seed(c.seed)
        trainer = build_trainer(c, dm)
        if on_build is not None:
            build = trainer.build_model

            def build_model():
                build()
                on_build(trainer)

            trainer.build_model = build_model
        fa.reset_launch_counts()
        start = time.perf_counter()
        trainer.train()
        seconds = time.perf_counter() - start
        launches = dict(fa.LAUNCHES)
        with open(os.path.join(out_dir, "metrics.json")) as f:
            metrics = json.load(f)["metrics"]
    log(f"[{c.trainer_name}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for key in ("top1_acc", "macro_f1", "ece", "aece"):
        if not np.isfinite(metrics[key]):
            raise RuntimeError(f"{c.trainer_name} metrics.json: {key} = {metrics[key]}")
    return launches, metrics, seconds, trainer


def _check_launches(what, launches, need):
    log(f"[{what}] launches {launches} (need at least {need})")
    for name, count in need.items():
        if launches[name] < count:
            raise RuntimeError(f"{what}: {name} launched {launches[name]} times on "
                               f"the main path; expected at least {count}")


def _metrics_line(metrics):
    return (f"top1_acc {metrics['top1_acc']:.2f} macro_f1 {metrics['macro_f1']:.2f} "
            f"ece {metrics['ece']:.2f} aece {metrics['aece']:.2f}")


def phase_trainer(backbone="ViT-B/16"):
    """The Adapter + GP flow; every frozen encode launches K1 and K2."""
    from clip_gp_tpu_torch.methods import common

    c, arch = _config(backbone, "Adapter", shots=4, epochs=3)
    c.adapter.use_gp = True
    c.adapter.num_templates = 16
    c.optim.name = "adamw"
    c.optim.lr = 1e-3
    dm = InMemoryDataManager(c, images_per_class=20)
    n_train, n_test = len(dm.dataset.train_x), len(dm.dataset.test)
    launches, metrics, seconds, _ = _train(c, dm)
    batch = common.EXTRACT_DEVICE_BATCH
    image_encodes = math.ceil(n_test / batch) + math.ceil(n_train / batch)
    text_encodes = math.ceil(4 * c.adapter.num_templates / 256)
    need = (arch.vision_layers * image_encodes
            + arch.transformer_layers * text_encodes)
    log(f"[trainer] Adapter+GP {backbone}: {n_train} train / {n_test} test "
        f"images, {c.adapter.num_templates} templates, "
        f"{c.adapter.clip_adapter_epochs} epochs in {seconds:.2f} s; "
        f"{_metrics_line(metrics)}")
    _check_launches("trainer", launches, {"fused_ln_attention_block": need,
                                          "fused_ln_mlp": need})
    return launches


def _snapshot(trainer):
    """A copy of the trainer's parameters, flat."""
    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v.detach().clone()

    return dict(flat(trainer.params))


def _moved(before, trainer):
    """Largest change of each parameter since ``before``."""
    after = _snapshot(trainer)
    return {k: (after[k] - before[k]).abs().max().item() for k in before}


def phase_coop(backbone="ViT-B/16", classes=100):
    """Adapter-CoOp: every step encodes its images (K1/K2 through the image
    tower), then runs the text tower over the K prompts forward (K1/K2) and
    backward (K4/K3) in each of the 12 blocks."""
    c, arch = _config(backbone, "Adapter-CoOp", shots=4, epochs=2)
    c.adapter.n_ctx = 16
    dm = InMemoryDataManager(c, images_per_class=5, num_classes=classes)
    before = {}
    launches, metrics, seconds, trainer = _train(
        c, dm, on_build=lambda t: before.update(_snapshot(t)))
    steps = c.adapter.clip_adapter_epochs * len(dm.train_loader_x)
    moved = _moved(before, trainer)
    log(f"[coop] Adapter-CoOp {backbone}: {classes} classes, "
        f"{len(dm.dataset.train_x)} train / {len(dm.dataset.test)} test images, "
        f"n_ctx {c.adapter.n_ctx}, {steps} steps in {seconds:.2f} s; "
        f"{_metrics_line(metrics)}; parameters moved by up to {moved}")
    layers = arch.transformer_layers
    _check_launches("coop", launches, {
        "fused_ln_attention_block": 2 * layers * steps, "fused_ln_mlp": 2 * layers * steps,
        "ln_attn_bwd": layers * steps, "ln_mlp_bwd": layers * steps,
    })
    if not moved["ctx"] > 0:
        raise RuntimeError("coop: the context did not move")
    return launches


def phase_cocoop(backbone="ViT-B/16", classes=100):
    """Adapter-CoCoOp: each step runs its images' K prompts through the text
    tower in chunks of PROMPT_BUDGET // K images, each chunk a checkpoint
    segment: K1/K2 forward, again in the backward's recompute, then K4/K3,
    in each of the 12 blocks."""
    from clip_gp_tpu_torch.methods import cocoop

    c, arch = _config(backbone, "Adapter-CoCoOp", shots=1, epochs=1)
    dm = InMemoryDataManager(c, images_per_class=2, num_classes=classes)
    before = {}
    launches, metrics, seconds, trainer = _train(
        c, dm, on_build=lambda t: before.update(_snapshot(t)))
    chunk = max(1, cocoop.PROMPT_BUDGET // classes)
    chunks = c.adapter.clip_adapter_epochs * sum(
        math.ceil(len(batch["label"]) / chunk) for batch in dm.train_loader_x)
    moved = _moved(before, trainer)
    log(f"[cocoop] Adapter-CoCoOp {backbone}: {classes} classes, "
        f"{len(dm.dataset.train_x)} train / {len(dm.dataset.test)} test images, "
        f"{chunks} chunks of {chunk} images x {classes} prompts in "
        f"{seconds:.2f} s; {_metrics_line(metrics)}; parameters moved by up to "
        f"{moved}")
    layers = arch.transformer_layers
    _check_launches("cocoop", launches, {
        "fused_ln_attention_block": 2 * layers * chunks,
        "fused_ln_mlp": 2 * layers * chunks,
        "ln_attn_bwd": layers * chunks, "ln_mlp_bwd": layers * chunks,
    })
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"cocoop: a parameter did not move: {moved}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import clip_gp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the clip_gp_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    device, smi = phase_build()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    cells = phase_kernels(device, peaks) + phase_bwd_kernels(device, peaks)
    phase_towers(device)
    by_path = {"adapter_gp": phase_trainer(), "coop": phase_coop(),
               "cocoop": phase_cocoop()}
    for cell in cells:
        counts = {path: launches[cell["kernel"]] for path, launches in by_path.items()}
        cell["launches"] = sum(counts.values())
        cell["launches_by_path"] = counts
    log(json.dumps({"kernels": cells}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
