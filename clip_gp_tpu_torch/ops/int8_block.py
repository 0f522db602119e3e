"""The int8 transformer sub-blocks of the int8 ViT image tower (serving).

- ``q8_ln_attention_block`` (K5) computes ``x + Σ_h quant(attn_h)·Wout_q[h]·s
  + b`` with an int8 qkv projection: it replaces the Pallas kernel
  ``_q8_ln_block_kernel`` of ``clip_gp_tpu/ops/int8_block.py``.
- ``q8_ln_mlp`` (K6) computes ``x + deq(quant(GELU(deq(quant(LN x)·Wfc_q) +
  b))·Wproj_q) + b``: it replaces ``_q8_mlp_kernel`` of the same file.

The recipe is the JAX package's: weights are int8 with one fp32 scale per
output channel (``models/quantized.py:quantize_weight``), activations are
quantized per row on the fly (``quantize_rows``: absmax/127, at least 1e-12,
round half to even, clip ±127), every product accumulates exactly in int32
and is rescaled in fp32. The LayerNorm and QuickGELU outputs are quantized
in fp32, never cast to the working type first; the attention core runs in
the working type with an fp32 softmax, and each head's fp32 output is
quantized per (row, head) before its slice of the out-projection, whose
int32 partials are scaled head by head into an fp32 sum.

On a CUDA tensor each wrapper launches the hand-written kernels of
``csrc/int8_block.cu`` and ``csrc/attention.cu`` (built at first use, see
``_build.py``): K5 = LN + quantize → int8 GEMM (qkv) → attention with a
quantize epilogue → int8 GEMM over the heads with the residual epilogue; K6
= LN + quantize → int8 GEMM with the QuickGELU epilogue (fp32 hidden) →
quantize → int8 GEMM with the residual epilogue. On a CPU tensor it runs the
plain PyTorch version beside it (``q8_ln_attention_block_plain``,
``q8_ln_mlp_plain``), which rounds where the Pallas kernel rounds. There is
no other route: a CUDA tensor never reaches the plain version through a
wrapper.

Inference only, as the Pallas kernels (which have no VJP): a call on any
device with autograd enabled and an input that requires a gradient raises.
``LAUNCHES`` counts each wrapper's launches on a CUDA tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from clip_gp_tpu_torch.ops import _build
from clip_gp_tpu_torch.ops.flash_attention import (
    _DTYPE_CODE,
    _EPI_GELU,
    _EPI_QKV,
    _EPI_RESID_ATTN,
    _EPI_RESID_MLP,
    HEAD_DIM,
    MAX_TOKENS,
    _f32,
    _mm,
    _ptr,
    layer_norm_f32,
)

LAUNCHES: Dict[str, int] = {"q8_ln_attention_block": 0, "q8_ln_mlp": 0}

QUANT_EPS = 1e-12
# the int8 GEMM of csrc/int8_block.cu steps K by 32 bytes
_K_STEP = 32


def reset_launch_counts() -> None:
    _build.reset_counts(LAUNCHES)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the on-card reference)
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of ``x [..., I]``: (int8 [..., I],
    fp32 scale [..., 1]), as the JAX package's ``quantize_rows``."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by the rounded reciprocal, which can differ in the last bit
    # from the IEEE division of the JAX package and of the kernels
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), QUANT_EPS)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``a [M, K]`` and ``b [K, N]``. A matmul of
    two int8 tensors would return int8 and overflow, so the CPU product runs
    in int32. CUDA has no int32 matmul and fp32 is not exact at K = 3072
    (127²·3072 > 2²⁴), so the card's runs in float64, exact below 2⁵³."""
    if a.device.type == "cuda":
        return (a.double() @ b.double()).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def q8_gemm_plain(a, w, row_scale, col_scale, bias, epilogue: str, out_dtype,
                  group_k: Optional[int] = None, resid=None):
    """Plain version of the int8 GEMM of ``csrc/int8_block.cu`` in the
    kernel's order: ``a`` int8 [M, K], ``w`` int8 [K, N], ``row_scale`` fp32
    [M, K / group_k] (``group_k`` all of K by default), ``col_scale`` and
    ``bias`` fp32 [N]. Each group's exact int32 product is scaled as
    part·row_scale·col_scale; with more than one group the scaled parts are
    summed from zero in group order. ``epilogue`` names K5's or K6's
    ("qkv", "gelu", "resid_attn", "resid_mlp"); ``resid`` [M, N] is read by
    the residual ones."""
    k = a.shape[1]
    group_k = group_k or k
    col_scale = col_scale.float()
    if group_k == k:
        acc = int8_matmul(a, w).float() * row_scale.reshape(-1, 1) * col_scale
    else:
        acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32,
                          device=a.device)
        for grp, k0 in enumerate(range(0, k, group_k)):
            part = int8_matmul(a[:, k0:k0 + group_k], w[k0:k0 + group_k])
            acc = acc + part.float() * row_scale[:, grp:grp + 1] * col_scale
    b = bias.float()
    if epilogue == "qkv":
        out = acc + b
    elif epilogue == "gelu":
        h = acc + b
        out = h * torch.sigmoid(1.702 * h)
    elif epilogue == "resid_attn":
        out = (resid.float() + acc) + b
    else:
        out = resid.float() + (acc + b)
    return out.to(out_dtype)


def q8_ln_attention_block_plain(x, ln_scale, ln_bias, wqkv_q, wqkv_scale, b_qkv,
                                wout_q, wout_scale, b_out, num_heads: int,
                                mask=None, wqkv_qt=None, wout_qt=None):
    """Plain PyTorch K5, rounding where ``_q8_ln_block_kernel`` rounds (it
    takes the wrapper's arguments; the K-major copies are not used): the
    LN output is quantized in fp32; qkv = (acc·hs·s_qkv + b_qkv) in fp32,
    rounded to ``x.dtype``; q is scaled by 1/√dh in the working type; the
    probabilities round to it before p·v; each head's fp32 output is
    quantized per (row, head), and the out-projection sums the heads in head
    order in fp32 as part·os·s_out; the result is (x32 + acc) + b_out."""
    dt = x.dtype
    b, n, d = x.shape
    dh = d // num_heads
    x32 = x.float()
    hq, hs = quantize_rows(layer_norm_f32(x32, ln_scale, ln_bias))
    acc = int8_matmul(hq.reshape(-1, d), wqkv_q).reshape(b, n, 3 * d)
    qkv = (acc.float() * hs * wqkv_scale.float() + b_qkv.float()).to(dt)
    q, k, v = (
        t.reshape(b, n, num_heads, dh).transpose(1, 2)
        for t in qkv.split(d, dim=-1)
    )
    q = q * (1.0 / dh**0.5)
    scores = _mm(q, k.transpose(-1, -2))
    if mask is not None:
        scores = scores + mask.float()
    scores = scores - scores.amax(-1, keepdim=True)
    weights = scores.exp()
    weights = weights / weights.sum(-1, keepdim=True)
    out_h = _mm(weights.to(dt), v)  # [B, H, N, dh] fp32
    oq, os = quantize_rows(out_h)
    acc = torch.zeros(b, n, d, dtype=torch.float32, device=x.device)
    for h in range(num_heads):
        part = int8_matmul(oq[:, h].reshape(-1, dh), wout_q[h * dh:(h + 1) * dh])
        acc = acc + part.reshape(b, n, d).float() * os[:, h] * wout_scale.float()
    return ((x32 + acc) + b_out.float()).to(dt)


def q8_ln_mlp_plain(x, ln_scale, ln_bias, wfc_q, wfc_scale, b_fc, wpr_q,
                    wpr_scale, b_pr, wfc_qt=None, wpr_qt=None):
    """Plain PyTorch K6, rounding where ``_q8_mlp_kernel`` rounds (it takes
    the wrapper's arguments; the K-major copies are not used): the LN
    output and the fp32 QuickGELU hidden are each quantized per row; biases,
    GELU and the residual are fp32; only the result rounds to ``x.dtype``."""
    dt = x.dtype
    b, n, d = x.shape
    x32 = x.float()
    hq, hs = quantize_rows(layer_norm_f32(x32, ln_scale, ln_bias))
    hid = (int8_matmul(hq.reshape(-1, d), wfc_q).float() * hs.reshape(-1, 1)
           * wfc_scale.float() + b_fc.float())
    hid = hid * torch.sigmoid(1.702 * hid)
    gq, gs = quantize_rows(hid)
    out = int8_matmul(gq, wpr_q).float() * gs * wpr_scale.float() + b_pr.float()
    return (x32 + out.reshape(b, n, d)).to(dt)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, x, int8_weights, vectors, mask=None):
    """Shared checks of the wrappers; raises on anything the kernels do not
    take. ``int8_weights`` maps names to ``(tensor, expected shape)``,
    ``vectors`` to ``(tensor, expected length)``."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, N, D] tensor")
    if x.shape[1] > MAX_TOKENS:
        raise ValueError(f"{name}: needs N <= {MAX_TOKENS}, got {tuple(x.shape)}: "
                         "the int8 tower's attention core has no key-tiled form")
    if x.shape[2] % HEAD_DIM:
        raise ValueError(f"{name}: needs D % {HEAD_DIM} == 0, got {tuple(x.shape)}")
    tensors = [x]
    for key, (w, shape) in int8_weights.items():
        if w.dtype != torch.int8 or not w.is_contiguous() or tuple(w.shape) != shape:
            raise ValueError(f"{name}: {key} must be a contiguous int8 tensor of "
                             f"shape {shape}, got {w.dtype} {tuple(w.shape)}")
        tensors.append(w)
    for key, (v, length) in vectors.items():
        if not v.is_floating_point() or tuple(v.shape) != (length,):
            raise ValueError(f"{name}: {key} must be a float tensor of shape "
                             f"({length},), got {v.dtype} {tuple(v.shape)}")
        tensors.append(v)
    if mask is not None:
        n = x.shape[1]
        if tuple(mask.shape) != (n, n) or not mask.is_contiguous():
            raise ValueError(f"{name}: mask must be contiguous [N, N]")
        tensors.append(mask)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: inference only, the int8 kernels have no "
                           "gradient; call it under torch.no_grad()")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


@_build.on_tensor_device
def _quantize(lib, x2d, stream, gamma=None, beta=None):
    """(int8 codes, fp32 row scales) of the rows of ``x2d``, LayerNormed
    first when ``gamma``/``beta`` are given."""
    rows, cols = x2d.shape
    q = torch.empty(rows, cols, dtype=torch.int8, device=x2d.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    _build.check(
        lib.cgt_q8_quantize(_ptr(x2d), _ptr(gamma), _ptr(beta), _ptr(q),
                            _ptr(scale), rows, cols, _DTYPE_CODE[x2d.dtype],
                            stream),
        "q8_quantize",
    )
    return q, scale


@_build.on_tensor_device
def _q8_gemm(lib, a, w, row_scale, col_scale, bias, out, epilogue, stream,
             group_k=None, resid=None, wt=None):
    """``out = epilogue(Σ_groups (A·W)_group · row_scale · col_scale)``: one
    int8 product whose int32 partial over each ``group_k`` columns of K (all
    of K by default; one head's 64 for the out-projection) is scaled into an
    fp32 sum; ``out``'s dtype is the working type (fp32 for the hidden). W
    comes in the JAX layout [K, N]; the kernel reads it K-major, as ``wt``
    [N, K] (``quantize_visual``'s "qt"), or from a transposed copy made here
    when ``wt`` is None."""
    m, k = a.shape
    n = w.shape[1]
    if wt is None:
        wt = w.t().contiguous()
    _build.check(
        lib.cgt_q8_gemm(_ptr(a), _ptr(wt), _ptr(row_scale), _ptr(col_scale),
                        _ptr(bias), _ptr(resid), _ptr(out), m, n, k,
                        group_k or k, _DTYPE_CODE[out.dtype], epilogue, stream),
        "q8_gemm",
    )


def quantize_rows_kernel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows`` of a contiguous fp32 ``[rows, cols]`` tensor through
    the row-quantize kernel of K6 on a CUDA tensor (the plain version on a
    CPU one): (int8 [rows, cols], fp32 scale [rows, 1])."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("quantize_rows_kernel: x must be a contiguous fp32 "
                         "[rows, cols] tensor")
    if x.device.type == "cpu":
        return quantize_rows(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows_kernel: unsupported device {x.device}")
    q, scale = _quantize(_build.library(), x, _stream(x))
    return q, scale[:, None]


def _k_major(weights):
    """The given K-major copies ``{key: (tensor or None, [K, N] weight)}``
    in ``_check``'s form: each must be shaped [N, K]."""
    return {key: (wt, tuple(w.shape[::-1])) for key, (wt, w) in weights.items()
            if wt is not None}


@_build.on_tensor_device
def q8_ln_attention_block(x, ln_scale, ln_bias, wqkv_q, wqkv_scale, b_qkv,
                          wout_q, wout_scale, b_out, num_heads: int,
                          mask: Optional[torch.Tensor] = None,
                          wqkv_qt: Optional[torch.Tensor] = None,
                          wout_qt: Optional[torch.Tensor] = None):
    """K5: ``x + MHA(LN(x))`` with int8 qkv and out projections, for x
    [B, N, D] (fp32 or bf16); wqkv_q int8 [D, 3D] with fp32 scales [3D],
    wout_q int8 [D, D] with scales [D] (``quantize_weight``), biases used in
    fp32, mask an optional additive fp32 [N, N]; wqkv_qt and wout_qt the
    weights' K-major copies [N, K] (``quantize_visual``'s "qt"), made per
    call when not given. Returns x's dtype."""
    b, n, d = x.shape
    name = "q8_ln_attention_block"
    _check(name, x, {"wqkv_q": (wqkv_q, (d, 3 * d)), "wout_q": (wout_q, (d, d)),
                     **_k_major({"wqkv_qt": (wqkv_qt, wqkv_q),
                                 "wout_qt": (wout_qt, wout_q)})},
           {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
            "wqkv_scale": (wqkv_scale, 3 * d), "b_qkv": (b_qkv, 3 * d),
            "wout_scale": (wout_scale, d), "b_out": (b_out, d)}, mask)
    if d // num_heads != HEAD_DIM or d % num_heads:
        raise ValueError(f"{name}: head width must be {HEAD_DIM}, got D={d}, "
                         f"heads={num_heads}")
    if x.device.type == "cpu":
        return q8_ln_attention_block_plain(x, ln_scale, ln_bias, wqkv_q,
                                           wqkv_scale, b_qkv, wout_q,
                                           wout_scale, b_out, num_heads, mask)
    lib = _build.library()
    stream = _stream(x)
    t = b * n
    x2d = x.view(t, d)
    hq, hs = _quantize(lib, x2d, stream, _f32(ln_scale), _f32(ln_bias))
    qkv = torch.empty(t, 3 * d, dtype=x.dtype, device=x.device)
    _q8_gemm(lib, hq, wqkv_q, hs, _f32(wqkv_scale), _f32(b_qkv), qkv, _EPI_QKV,
             stream, wt=wqkv_qt)
    oq = torch.empty(t, d, dtype=torch.int8, device=x.device)
    os = torch.empty(t, num_heads, dtype=torch.float32, device=x.device)
    mask32 = None if mask is None else _f32(mask)
    _build.check(
        lib.cgt_attention_q8(_ptr(qkv), _ptr(mask32), _ptr(oq), _ptr(os), b, n,
                             num_heads, d, _DTYPE_CODE[x.dtype], stream),
        "attention_q8",
    )
    out = torch.empty_like(x)
    _q8_gemm(lib, oq, wout_q, os, _f32(wout_scale), _f32(b_out), out.view(t, d),
             _EPI_RESID_ATTN, stream, group_k=HEAD_DIM, resid=x2d, wt=wout_qt)
    _build.count_launch(LAUNCHES, name)
    return out


def q8_ln_mlp(x, ln_scale, ln_bias, wfc_q, wfc_scale, b_fc, wpr_q, wpr_scale,
              b_pr, wfc_qt: Optional[torch.Tensor] = None,
              wpr_qt: Optional[torch.Tensor] = None):
    """K6: ``x + MLP(LN(x))`` with int8 c_fc and c_proj, for x [B, N, D]
    (fp32 or bf16); wfc_q int8 [D, H] with fp32 scales [H], wpr_q int8
    [H, D] with scales [D], biases used in fp32; wfc_qt and wpr_qt the
    weights' K-major copies, as K5's. Returns x's dtype."""
    b, n, d = x.shape
    hidden = wfc_q.shape[-1]
    name = "q8_ln_mlp"
    _check(name, x, {"wfc_q": (wfc_q, (d, hidden)), "wpr_q": (wpr_q, (hidden, d)),
                     **_k_major({"wfc_qt": (wfc_qt, wfc_q),
                                 "wpr_qt": (wpr_qt, wpr_q)})},
           {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
            "wfc_scale": (wfc_scale, hidden), "b_fc": (b_fc, hidden),
            "wpr_scale": (wpr_scale, d), "b_pr": (b_pr, d)})
    if hidden % _K_STEP:
        raise ValueError(f"{name}: hidden width must be a multiple of {_K_STEP}")
    if x.device.type == "cpu":
        return q8_ln_mlp_plain(x, ln_scale, ln_bias, wfc_q, wfc_scale, b_fc,
                               wpr_q, wpr_scale, b_pr)
    lib = _build.library()
    stream = _stream(x)
    t = b * n
    x2d = x.view(t, d)
    hq, hs = _quantize(lib, x2d, stream, _f32(ln_scale), _f32(ln_bias))
    hid = torch.empty(t, hidden, dtype=torch.float32, device=x.device)
    _q8_gemm(lib, hq, wfc_q, hs, _f32(wfc_scale), _f32(b_fc), hid, _EPI_GELU,
             stream, wt=wfc_qt)
    gq, gs = _quantize(lib, hid, stream)
    out = torch.empty_like(x)
    _q8_gemm(lib, gq, wpr_q, gs, _f32(wpr_scale), _f32(b_pr), out.view(t, d),
             _EPI_RESID_MLP, stream, resid=x2d, wt=wpr_qt)
    _build.count_launch(LAUNCHES, name)
    return out
