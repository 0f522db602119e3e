#!/usr/bin/env python3
"""A/B timing of the port's kernels in several checkouts, on one GPU.

    python3 chip_ab.py PARENT . . PARENT

Each argument is the root of a checkout that holds ``clip_gp_tpu_torch/``
(an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, or ``.`` for this one). Each runs in a process of its
own, in the order given, so "parent, change, change, parent" spreads any
drift of the card over both. A run builds that checkout's kernels (cached in
its ``build/kernels``), then times the cells of ``CELLS`` with
``chip_smoke.py``'s timer and inputs (median of 20 CUDA-event timings after
3 warm-ups, the same seeds in every run). It prints one line per run and
cell, then, as its last line, one JSON object with the card and every run's
times. K1, K5, K7 and K8 share the attention core; K1, K2 and K8 share the
GEMM of ``ln_gemm.cu``, whose bf16 and fp32 paths are separate, so the fp32
cells control a bf16 change and K5 and K7 a GEMM change. K5 and K6 (at
ViT-B/16 B=32 and 512, bf16, the serving dtype) alone run the int8 GEMM of
``int8_block.cu``, which the other cells control. Its fp32 products
run the 3xTF32 core of ``gemm_tf32.cuh``, as K3 and K4 (the backward
kernels, dx only as the prompt learners launch them, at the trimmed text
tower's CoOp step B=100 and CoCoOp chunk B=256, and K3 fp32 at B=100 on
the untrimmed tower's 77 tokens) do through ``gemm_bwd.cu``, so a change to
that core moves both, and the bf16 cells control it. K3 alone runs the
attention backward of ``attention_bwd.cu``, which three cells also time on
its own through its C entry. The
fp32 forward cells include ViT-B/16 at 32 images, the batch of a CoOp
step's image encode.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# (label, kernel, batch, tokens, width, heads, causal, dtype)
CELLS = [
    ("K7 ViT B=512 bf16", "flash_attention", 512, 197, 768, 12, False, "bf16"),
    ("K7 ViT B=512 fp32", "flash_attention", 512, 197, 768, 12, False, "fp32"),
    ("K7 text B=256 bf16", "flash_attention", 256, 77, 512, 8, True, "bf16"),
    ("K1 ViT B=512 bf16", "fused_ln_attention_block", 512, 197, 768, 12, False, "bf16"),
    ("K1 ViT B=512 fp32", "fused_ln_attention_block", 512, 197, 768, 12, False, "fp32"),
    ("K1 ViT B=32 fp32", "fused_ln_attention_block", 32, 197, 768, 12, False, "fp32"),
    ("K5 ViT B=512 bf16", "q8_ln_attention_block", 512, 197, 768, 12, False, "bf16"),
    ("K5 ViT B=32 bf16", "q8_ln_attention_block", 32, 197, 768, 12, False, "bf16"),
    ("K6 ViT B=512 bf16", "q8_ln_mlp", 512, 197, 768, 12, False, "bf16"),
    ("K6 ViT B=32 bf16", "q8_ln_mlp", 32, 197, 768, 12, False, "bf16"),
    ("K8 ViT B=512 bf16", "fused_attention_block", 512, 197, 768, 12, False, "bf16"),
    ("K8 ViT B=512 fp32", "fused_attention_block", 512, 197, 768, 12, False, "fp32"),
    ("K2 ViT B=512 bf16", "fused_ln_mlp", 512, 197, 768, 12, False, "bf16"),
    ("K2 ViT B=512 fp32", "fused_ln_mlp", 512, 197, 768, 12, False, "fp32"),
    ("K2 ViT B=32 fp32", "fused_ln_mlp", 32, 197, 768, 12, False, "fp32"),
] + [
    (f"{name} dx text B={b} {dtype}", kernel, b, 24, 512, 8, True, dtype)
    for name, kernel in (("K3", "ln_attn_bwd"), ("K4", "ln_mlp_bwd"))
    for b in (100, 256) for dtype in ("fp32", "bf16")
] + [
    # K3 at a CoOp step on the untrimmed text tower (77 tokens)
    ("K3 dx text B=100 N=77 fp32", "ln_attn_bwd", 100, 77, 512, 8, True, "fp32"),
] + [
    # K3's attention backward alone (attention_bwd.cu through its C entry,
    # dqkv only, as the dx-only call launches it)
    (f"K3 attention backward text B={b} N={n} fp32", "attention_bwd", b, n, 512, 8,
     True, "fp32")
    for b, n in ((256, 24), (100, 24), (100, 77))
]


def _smoke():
    """chip_smoke.py of this checkout, for its timer and input makers (it
    imports the package only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _call(kernel, b, n, d, heads, causal, dtype_name, device, cs):
    """A closure that launches ``kernel`` once on the cell's inputs."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa
    from clip_gp_tpu_torch.ops import int8_block as ib

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    if kernel == "attention_bwd":
        from clip_gp_tpu_torch.ops import _build

        lib = _build.library()
        g = torch.Generator().manual_seed(b + n)
        qkv = torch.randn(b * n, 3 * d, generator=g).to(device)
        d_attn = torch.randn(b * n, d, generator=g).to(device)
        mask = torch.triu(torch.full((n, n), float("-inf")), 1).to(device)
        dqkv = torch.empty_like(qkv)
        row_stats = torch.empty(b * n * heads, 3, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream

        def run():
            return lib.cgt_attention_bwd(qkv.data_ptr(), d_attn.data_ptr(),
                                         mask.data_ptr(), dqkv.data_ptr(), None,
                                         row_stats.data_ptr(), b, n, heads, d,
                                         stream)

        _build.check(run(), "attention_bwd")
        return run
    if kernel == "flash_attention":
        g = torch.Generator().manual_seed(b + n)
        q, k, v = (torch.randn(b, heads, n, d // heads, generator=g).to(device, dtype)
                   for _ in range(3))
        mask = (torch.triu(torch.full((n, n), float("-inf")), 1).to(device)
                if causal else None)
        return lambda: fa.flash_attention(q, k, v, mask)
    if kernel.startswith("q8_"):
        p = cs._q8_block_inputs(b, n, d, dtype_name, device, seed=900)
    else:
        p = cs._block_inputs(b, n, d, causal, dtype, device, seed=900)
    if kernel in ("ln_attn_bwd", "ln_mlp_bwd"):
        g = torch.Generator().manual_seed(901)
        dout = torch.randn(b, n, d, generator=g).to(device, dtype)
        args = ((p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
                 p["w_out"], p["mask"], heads, dout) if kernel == "ln_attn_bwd" else
                (p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"],
                 p["w_proj"], dout))
        fn = getattr(fa, kernel)
        return lambda: fn(*args, param_grads=False)
    fn = getattr(ib if kernel.startswith("q8_") else fa, kernel)
    args = cs._block_args(kernel, p, heads)
    if kernel.startswith("q8_") and len(args) > len(inspect.signature(fn).parameters):
        args = args[:-2]  # a checkout whose K5/K6 take no K-major weight copies
    return lambda: fn(*args)


def run_tree(tree: str) -> int:
    """One run: time every cell with the kernels of the checkout at ``tree``
    and print the times as one JSON object on the last line."""
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import torch

    import clip_gp_tpu_torch
    from clip_gp_tpu_torch.ops import _build

    package = Path(clip_gp_tpu_torch.__file__).resolve().parent
    if package.parent != root:
        raise RuntimeError(f"imported {package}, not the checkout at {root}")
    cs = _smoke()
    device = torch.device("cuda")
    _build.library()
    times = {}
    with torch.no_grad():
        for label, *cell in CELLS:
            times[label] = cs.time_ms(_call(*cell, device, cs))
            torch.cuda.empty_cache()
    print(json.dumps({"tree": str(root), "build_s": _build.last_build["seconds"],
                      "ms": times}), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--run":
        return run_tree(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for i, tree in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--run", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise RuntimeError(f"run {i} ({tree}) exited {proc.returncode}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        for label, ms in run["ms"].items():
            print(f"[ab] run {i} {tree}: {label} {ms:.4f} ms", flush=True)
    print(json.dumps({"card": smi, "order": argv, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
