"""The fused transformer sub-blocks of the CLIP towers and their gradients.

- ``fused_ln_attention_block`` (K1) computes ``x + MHA(LN(x)·Wqkv + bqkv)·Wout
  + bout``. It replaces the Pallas kernel ``_fused_ln_block_kernel`` of
  ``clip_gp_tpu/ops/flash_attention.py``.
- ``fused_ln_mlp`` (K2) computes ``x + c_proj(QuickGELU(c_fc(LN(x))))``. It
  replaces the Pallas kernel ``_fused_mlp_kernel`` of the same file.
- ``ln_attn_bwd`` (K3) and ``ln_mlp_bwd`` (K4) are their backward passes,
  replacing ``_ln_attn_bwd_kernel`` and ``_ln_mlp_bwd_kernel``: from the
  block's primal inputs and the output gradient they recompute the block in
  fp32 (LN, qkv or the ``[T,4D]`` hidden, the softmax) and return dx, dγ,
  dβ and the four weight and bias gradients.

On a CUDA tensor each wrapper launches the hand-written kernels of
``clip_gp_tpu_torch/csrc`` (built at first use, see ``_build.py``):
K1 = LN statistics → LN-prologue GEMM (qkv) → attention → GEMM with
bias + residual epilogue; K2 = LN statistics → LN-prologue GEMM with
QuickGELU epilogue → GEMM with bias + residual epilogue; K3 and K4 = the fp32
GEMMs of ``gemm_bwd.cu`` (transposed operands, LN and QuickGELU prologues, a
QuickGELU-derivative epilogue), the attention backward of
``attention_bwd.cu`` and the LN backward and column sums of ``ln_bwd.cu``.
In this version the qkv and hidden intermediates pass through device memory.
On a CPU tensor the wrapper runs the plain PyTorch version beside it
(``ln_attention_block_plain``, ``ln_mlp_plain``, ``ln_attn_bwd_plain``,
``ln_mlp_bwd_plain``), which rounds where the Pallas kernel rounds. There is
no other route: a CUDA tensor never reaches the plain version through a
wrapper.

K1 and K2 take fp32 or bf16 activations (the frozen encodes of the training
path run in fp32), head width 64 and sequences of at most 256 tokens. They
are differentiable: when autograd needs their gradient they run as
``torch.autograd.Function``s whose backward is K3/K4. The Function saves only
the block's primal inputs and the backward recomputes the rest, as the TPU
kernels do and as the JAX towers' per-block ``jax.checkpoint`` does. The
weight gradients are computed only when autograd asks for them. What bounds
each kernel on an H100 is stated at the top of its CUDA source.

``LAUNCHES`` counts each wrapper's kernel launches (one per call on a CUDA
tensor), so a run can show that its encodes went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from clip_gp_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {
    "fused_ln_attention_block": 0, "fused_ln_mlp": 0,
    "ln_attn_bwd": 0, "ln_mlp_bwd": 0,
}

HEAD_DIM = 64
MAX_TOKENS = 256
LN_EPS = 1e-5

# C-side enums of csrc/common.cuh, csrc/ln_gemm.cu and csrc/gemm_bwd.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_EPI_QKV, _EPI_GELU, _EPI_RESID_ATTN, _EPI_RESID_MLP = 0, 1, 2, 3
# backward products (gemm_bwd.cu): N = A·B, T = the operand read transposed
(_OP_LN_NN_BIAS, _OP_NT, _OP_NT_GELU_BWD, _OP_LN_TN, _OP_TN,
 _OP_GELU_TN) = range(6)
# rows per block of the first pass of a column sum (ln_bwd.cu)
_COLSUM_ROWS = 64


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the on-card reference)
# ---------------------------------------------------------------------------

def _ln_recompute(x, ln_scale, ln_bias):
    """(rstd, xhat, h): LayerNorm of ``x`` upcast to fp32 (eps 1e-5) with
    the row statistics the backward kernels use."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x32 - mean) * rstd
    return rstd, xhat, xhat * ln_scale.float() + ln_bias.float()


def layer_norm_f32(x, scale, bias):
    """LayerNorm of ``x`` upcast to fp32 (eps 1e-5), returned in fp32: the
    plain K1/K2 and the towers' ln_pre, ln_post and ln_final."""
    return _ln_recompute(x, scale, bias)[2]


def _mm(a, b):
    """Product of working-type operands with fp32 accumulation, as the Pallas
    kernels' ``preferred_element_type=float32`` dots: bf16 values are exact in
    fp32, so an fp32 product of the upcast operands is the same sum."""
    return a.float() @ b.float()


def ln_attention_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                             num_heads: int, mask=None):
    """Plain PyTorch K1, rounding where ``_fused_ln_block_kernel`` rounds:
    h, qkv (before and after adding b_qkv, itself rounded), the scaled q,
    the probabilities and each head's output round to ``x.dtype``; the
    out-projection sums the heads in fp32 and adds the residual and b_out in
    fp32."""
    dt = x.dtype
    b, n, d = x.shape
    dh = d // num_heads
    x32 = x.float()
    h = layer_norm_f32(x32, ln_scale, ln_bias).to(dt)
    qkv = _mm(h, w_qkv.to(dt)).to(dt) + b_qkv.to(dt)
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
    out_h = _mm(weights.to(dt), v).to(dt)
    attn = out_h.transpose(1, 2).reshape(b, n, d)
    return (x32 + _mm(attn, w_out.to(dt)) + b_out.float()).to(dt)


def ln_mlp_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """Plain PyTorch K2, rounding where ``_fused_mlp_kernel`` rounds: h and the
    QuickGELU output round to ``x.dtype``; biases, GELU and the residual are
    fp32."""
    dt = x.dtype
    x32 = x.float()
    h = layer_norm_f32(x32, ln_scale, ln_bias).to(dt)
    hid = _mm(h, w_fc.to(dt)) + b_fc.float()
    hid = hid * torch.sigmoid(1.702 * hid)
    out = _mm(hid.to(dt), w_proj.to(dt)) + b_proj.float()
    return (x32 + out).to(dt)


def _ln_backward(dout32, dh, rstd, xhat, ln_scale):
    """(dx fp32, dγ, dβ) from the gradient ``dh`` at the LN output."""
    rows = tuple(range(dh.dim() - 1))
    dg = (dh * xhat).sum(rows)
    db = dh.sum(rows)
    dxhat = dh * ln_scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return dout32 + rstd * (dxhat - m1 - xhat * m2), dg, db


def ln_attn_bwd_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, mask,
                      num_heads: int, dout):
    """Plain PyTorch K3, following ``_ln_attn_bwd_kernel``: every input is
    upcast to fp32 and the block is recomputed in fp32 (for a bf16 ``x`` this
    is an fp32 recompute, not the bf16 forward). Returns (dx in x.dtype, dγ,
    dβ, dWqkv, dbqkv, dWout, dbout): each gradient in its input's dtype,
    except dbout, which stays fp32 (the Pallas call site casts it)."""
    b, n, d = x.shape
    dh = d // num_heads
    inv = 1.0 / dh**0.5
    rstd, xhat, h = _ln_recompute(x, ln_scale, ln_bias)
    dout32 = dout.float()
    w_qkv32, w_out32 = w_qkv.float(), w_out.float()
    qkv = h @ w_qkv32 + b_qkv.float()

    def heads(t):  # [B, N, D] -> [B, H, N, dh]
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    def merge(t):  # [B, H, N, dh] -> [B, N, D]
        return t.transpose(1, 2).reshape(b, n, d)

    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    q_s = q * inv
    scores = q_s @ k.transpose(-1, -2)
    if mask is not None:
        scores = scores + mask.float()
    scores = scores - scores.amax(-1, keepdim=True)
    w = scores.exp()
    a = w / w.sum(-1, keepdim=True)
    out_h = a @ v
    d_outh = heads(dout32 @ w_out32.T)
    da = d_outh @ v.transpose(-1, -2)
    dv = a.transpose(-1, -2) @ d_outh
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dq = (ds @ k) * inv
    dk = ds.transpose(-1, -2) @ q_s
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    rows = (0, 1)
    dwqkv = h.reshape(-1, d).T @ dqkv.reshape(-1, 3 * d)
    dwout = merge(out_h).reshape(-1, d).T @ dout32.reshape(-1, d)
    dx, dg, db = _ln_backward(dout32, dqkv @ w_qkv32.T, rstd, xhat, ln_scale)
    return (dx.to(x.dtype), dg.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dwqkv.to(w_qkv.dtype), dqkv.sum(rows).to(b_qkv.dtype),
            dwout.to(w_out.dtype), dout32.sum(rows))


def ln_mlp_bwd_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, dout):
    """Plain PyTorch K4, following ``_ln_mlp_bwd_kernel``: an fp32 recompute
    of LN, the hidden and QuickGELU, then every gradient. Returns (dx in
    x.dtype, dγ, dβ, dWfc, dbfc, dWproj, dbproj): each gradient in its
    input's dtype, except dbproj, which stays fp32 (the Pallas call site
    casts it)."""
    d = x.shape[-1]
    rstd, xhat, h = _ln_recompute(x, ln_scale, ln_bias)
    dout32 = dout.float()
    w_fc32, w_proj32 = w_fc.float(), w_proj.float()
    hid_pre = h @ w_fc32 + b_fc.float()
    s = torch.sigmoid(1.702 * hid_pre)
    act = hid_pre * s
    dact = dout32 @ w_proj32.T
    dhid = dact * (s + 1.702 * hid_pre * s * (1.0 - s))
    rows = tuple(range(x.dim() - 1))
    dwproj = act.reshape(-1, act.shape[-1]).T @ dout32.reshape(-1, d)
    dwfc = h.reshape(-1, d).T @ dhid.reshape(-1, dhid.shape[-1])
    dx, dg, db = _ln_backward(dout32, dhid @ w_fc32.T, rstd, xhat, ln_scale)
    return (dx.to(x.dtype), dg.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dwfc.to(w_fc.dtype), dhid.sum(rows).to(b_fc.dtype),
            dwproj.to(w_proj.dtype), dout32.sum(rows))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_inputs(name, x, weights, vectors, mask=None):
    """Shared checks of the wrappers; raises on anything the kernels do not
    take. ``vectors`` maps each 1-D input's name to ``(tensor, expected
    length)``."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, N, D] tensor")
    if x.shape[1] > MAX_TOKENS or x.shape[2] % 8:
        raise ValueError(
            f"{name}: needs N <= {MAX_TOKENS} and D % 8 == 0, got {tuple(x.shape)}"
        )
    tensors = [x, *weights.values(), *(v for v, _ in vectors.values())]
    for key, w in weights.items():
        if w.dtype != x.dtype or not w.is_contiguous() or w.dim() != 2:
            raise ValueError(
                f"{name}: {key} must be a contiguous 2-D {x.dtype} tensor"
            )
    for key, (v, length) in vectors.items():
        if v.dtype not in _DTYPE_CODE or tuple(v.shape) != (length,):
            raise ValueError(
                f"{name}: {key} must be a float32 or bfloat16 tensor of shape "
                f"({length},), got {v.dtype} {tuple(v.shape)}"
            )
    if mask is not None:
        n = x.shape[1]
        if tuple(mask.shape) != (n, n) or not mask.is_contiguous():
            raise ValueError(f"{name}: mask must be contiguous [N, N]")
        if torch.is_grad_enabled() and mask.requires_grad:
            raise RuntimeError(f"{name}: the kernels give no gradient for the mask")
        tensors.append(mask)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_heads(name, x, w_qkv, w_out, num_heads):
    d = x.shape[2]
    if d % num_heads or d // num_heads != HEAD_DIM:
        raise ValueError(
            f"{name}: head width must be {HEAD_DIM}, got D={d}, heads={num_heads}"
        )
    if tuple(w_qkv.shape) != (d, 3 * d) or tuple(w_out.shape) != (d, d):
        raise ValueError(f"{name}: weight shapes do not match D")


def _check_mlp_shapes(name, x, w_fc, w_proj):
    d, hidden = x.shape[2], w_fc.shape[-1]
    if w_fc.shape[0] != d or tuple(w_proj.shape) != (hidden, d) or hidden % 8:
        raise ValueError(f"{name}: weight shapes do not match D")


def _check_grad(name, x, dout):
    if (dout.shape != x.shape or dout.dtype != x.dtype
            or dout.device != x.device or not dout.is_contiguous()):
        raise ValueError(
            f"{name}: dout must be a contiguous {x.dtype} tensor of x's shape "
            f"{tuple(x.shape)} on {x.device}"
        )


def _ptr(t: Optional[torch.Tensor]):
    if t is None:
        return None
    if t.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return t.data_ptr()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _row_stats(lib, x2d, stream):
    stats = torch.empty(x2d.shape[0], 2, dtype=torch.float32, device=x2d.device)
    _build.check(
        lib.cgt_ln_stats(_ptr(x2d), _ptr(stats), x2d.shape[0], x2d.shape[1],
                         _DTYPE_CODE[x2d.dtype], stream),
        "ln_stats",
    )
    return stats


def _gemm(lib, a, w, bias, out, epilogue, stream, resid=None, stats=None,
          gamma=None, beta=None):
    m, k = a.shape
    n = w.shape[1]
    _build.check(
        lib.cgt_gemm(_ptr(a), _ptr(w), _ptr(bias), _ptr(resid), _ptr(stats),
                     _ptr(gamma), _ptr(beta), _ptr(out), m, n, k,
                     _DTYPE_CODE[a.dtype], epilogue, stream),
        "ln_gemm",
    )


def _gemm_bwd(lib, op, a, b, m, n, k, stream, bias=None, aux=None, stats=None,
              gamma=None, beta=None):
    """One fp32 product of gemm_bwd.cu, returned as a new fp32 [m, n]
    tensor. The op's working-type operand (A of the N·· products, B of the
    T·N ones) may be bf16; every other operand is fp32. A T·N product (a
    weight gradient: a sum over all T rows) whose output tiles alone would
    not fill the card splits its K rows over ``splits`` blocks and sums the
    parts in a second pass, in a fixed order."""
    transposed_a = op in (_OP_LN_TN, _OP_TN, _OP_GELU_TN)
    io = b if op in (_OP_TN, _OP_GELU_TN) else a
    splits = 1
    if transposed_a:
        tiles = -(-m // 128) * -(-n // 128)
        splits = max(1, min(16, 264 // tiles, k // 512))
    out = torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
    _build.check(
        lib.cgt_gemm_bwd(_ptr(a), _ptr(b), _ptr(bias), _ptr(aux), _ptr(stats),
                         _ptr(gamma), _ptr(beta), _ptr(out), m, n, k, splits,
                         _DTYPE_CODE[io.dtype], op, stream),
        "gemm_bwd",
    )
    if splits == 1:
        return out[0]
    total = torch.empty(m, n, dtype=torch.float32, device=a.device)
    _build.check(lib.cgt_sum_parts(_ptr(out), _ptr(total), splits, m * n, stream),
                 "sum_parts")
    return total


def _colsum(lib, src2d, stream):
    """fp32 column sums of a [rows, cols] fp32 or bf16 tensor, in two passes
    (per-block partial sums, then one fixed-order reduce)."""
    rows, cols = src2d.shape
    chunks = -(-rows // _COLSUM_ROWS)
    partial = torch.empty(chunks, cols, dtype=torch.float32, device=src2d.device)
    out = torch.empty(cols, dtype=torch.float32, device=src2d.device)
    _build.check(
        lib.cgt_colsum(_ptr(src2d), _ptr(partial), _ptr(out), rows, cols,
                       _COLSUM_ROWS, _DTYPE_CODE[src2d.dtype], stream),
        "colsum",
    )
    return out


def _ln_bwd(lib, x2d, dout2d, dh, stats, gamma, stream, param_grads):
    """(dx in x's dtype, dγ, dβ) from the fp32 gradient ``dh`` at the LN
    output; dγ and dβ are None unless ``param_grads``."""
    rows, cols = x2d.shape
    dx = torch.empty_like(x2d)
    code = _DTYPE_CODE[x2d.dtype]
    _build.check(
        lib.cgt_ln_bwd(_ptr(x2d), _ptr(dout2d), _ptr(dh), _ptr(stats),
                       _ptr(gamma), _ptr(dx), rows, cols, code, stream),
        "ln_bwd",
    )
    if not param_grads:
        return dx, None, None
    chunks = -(-rows // _COLSUM_ROWS)
    partial = torch.empty(2, chunks, cols, dtype=torch.float32, device=dh.device)
    dg = torch.empty(cols, dtype=torch.float32, device=dh.device)
    db = torch.empty_like(dg)
    _build.check(
        lib.cgt_ln_param_grads(_ptr(dh), _ptr(x2d), _ptr(stats), _ptr(partial),
                               _ptr(dg), _ptr(db), rows, cols, _COLSUM_ROWS,
                               code, stream),
        "ln_param_grads",
    )
    return dx, dg, db


# ---------------------------------------------------------------------------
# K1 and K2: forward
# ---------------------------------------------------------------------------

def _ln_attention_forward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                          num_heads, mask):
    if x.device.type == "cpu":
        return ln_attention_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                        w_out, b_out, num_heads, mask)
    b, n, d = x.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x2d = x.view(b * n, d)
    qkv = torch.empty(b * n, 3 * d, dtype=x.dtype, device=x.device)
    attn = torch.empty(b * n, d, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stats = _row_stats(lib, x2d, stream)
    # the Pallas wrapper casts b_qkv to the working type, b_out to fp32
    _gemm(lib, x2d, w_qkv, _f32(b_qkv.to(x.dtype)), qkv, _EPI_QKV, stream,
          stats=stats, gamma=_f32(ln_scale), beta=_f32(ln_bias))
    mask32 = None if mask is None else _f32(mask)
    _build.check(
        lib.cgt_attention(_ptr(qkv), _ptr(mask32), _ptr(attn), b, n,
                          num_heads, d, _DTYPE_CODE[x.dtype], stream),
        "attention",
    )
    _gemm(lib, attn, w_out, _f32(b_out), out.view(b * n, d), _EPI_RESID_ATTN,
          stream, resid=x2d)
    LAUNCHES["fused_ln_attention_block"] += 1
    return out


def _ln_mlp_forward(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj)
    b, n, d = x.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x2d = x.view(b * n, d)
    hid = torch.empty(b * n, w_fc.shape[-1], dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stats = _row_stats(lib, x2d, stream)
    _gemm(lib, x2d, w_fc, _f32(b_fc), hid, _EPI_GELU, stream, stats=stats,
          gamma=_f32(ln_scale), beta=_f32(ln_bias))
    _gemm(lib, hid, w_proj, _f32(b_proj), out.view(b * n, d), _EPI_RESID_MLP,
          stream, resid=x2d)
    LAUNCHES["fused_ln_mlp"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 and K4: backward
# ---------------------------------------------------------------------------

def ln_attn_bwd(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, mask,
                num_heads: int, dout, param_grads: bool = True):
    """K3: the gradients of K1's output ``x + MHA(LN(x))`` given ``dout``
    [B, N, D] (x's dtype), recomputed from the primal inputs in fp32. Returns
    (dx, dγ, dβ, dWqkv, dbqkv, dWout, dbout) with the dtypes of
    ``ln_attn_bwd_plain``; the last six are None unless ``param_grads``."""
    b, n, d = x.shape
    name = "ln_attn_bwd"
    _check_inputs(name, x, {"w_qkv": w_qkv, "w_out": w_out},
                  {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
                   "b_qkv": (b_qkv, 3 * d)}, mask)
    _check_heads(name, x, w_qkv, w_out, num_heads)
    _check_grad(name, x, dout)
    if x.device.type == "cpu":
        grads = ln_attn_bwd_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                                  mask, num_heads, dout)
        return grads if param_grads else (grads[0],) + (None,) * 6
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    t = b * n
    x2d, dout2d = x.view(t, d), dout.view(t, d)
    gamma, w_qkv32 = _f32(ln_scale), _f32(w_qkv)
    stats = _row_stats(lib, x2d, stream)
    qkv = _gemm_bwd(lib, _OP_LN_NN_BIAS, x2d, w_qkv32, t, 3 * d, d, stream,
                    bias=_f32(b_qkv), stats=stats, gamma=gamma,
                    beta=_f32(ln_bias))
    d_attn = _gemm_bwd(lib, _OP_NT, dout2d, _f32(w_out), t, d, d, stream)
    dqkv = torch.empty(t, 3 * d, dtype=torch.float32, device=x.device)
    attn = (torch.empty(t, d, dtype=torch.float32, device=x.device)
            if param_grads else None)
    row_stats = torch.empty(t * num_heads, 3, dtype=torch.float32,
                            device=x.device)
    mask32 = None if mask is None else _f32(mask)
    _build.check(
        lib.cgt_attention_bwd(_ptr(qkv), _ptr(d_attn), _ptr(mask32),
                              _ptr(dqkv), _ptr(attn), _ptr(row_stats), b, n,
                              num_heads, d, stream),
        "attention_bwd",
    )
    dh = _gemm_bwd(lib, _OP_NT, dqkv, w_qkv32, t, d, 3 * d, stream)
    dx, dg, db = _ln_bwd(lib, x2d, dout2d, dh, stats, gamma, stream,
                         param_grads)
    LAUNCHES[name] += 1
    if not param_grads:
        return (dx.view(b, n, d),) + (None,) * 6
    dw_qkv = _gemm_bwd(lib, _OP_LN_TN, x2d, dqkv, d, 3 * d, t, stream,
                       stats=stats, gamma=gamma, beta=_f32(ln_bias))
    dw_out = _gemm_bwd(lib, _OP_TN, attn, dout2d, d, d, t, stream)
    return (dx.view(b, n, d), dg.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dw_qkv.to(w_qkv.dtype), _colsum(lib, dqkv, stream).to(b_qkv.dtype),
            dw_out.to(w_out.dtype), _colsum(lib, dout2d, stream))


def ln_mlp_bwd(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, dout,
               param_grads: bool = True):
    """K4: the gradients of K2's output ``x + MLP(LN(x))`` given ``dout``
    [B, N, D] (x's dtype), recomputed from the primal inputs in fp32. Returns
    (dx, dγ, dβ, dWfc, dbfc, dWproj, dbproj) with the dtypes of
    ``ln_mlp_bwd_plain``; the last six are None unless ``param_grads``."""
    b, n, d = x.shape
    hidden = w_fc.shape[-1]
    name = "ln_mlp_bwd"
    _check_inputs(name, x, {"w_fc": w_fc, "w_proj": w_proj},
                  {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
                   "b_fc": (b_fc, hidden)})
    _check_mlp_shapes(name, x, w_fc, w_proj)
    _check_grad(name, x, dout)
    if x.device.type == "cpu":
        grads = ln_mlp_bwd_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, dout)
        return grads if param_grads else (grads[0],) + (None,) * 6
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    t = b * n
    x2d, dout2d = x.view(t, d), dout.view(t, d)
    gamma, w_fc32 = _f32(ln_scale), _f32(w_fc)
    stats = _row_stats(lib, x2d, stream)
    hid = _gemm_bwd(lib, _OP_LN_NN_BIAS, x2d, w_fc32, t, hidden, d, stream,
                    bias=_f32(b_fc), stats=stats, gamma=gamma,
                    beta=_f32(ln_bias))
    dhid = _gemm_bwd(lib, _OP_NT_GELU_BWD, dout2d, _f32(w_proj), t, hidden, d,
                     stream, aux=hid)
    dh = _gemm_bwd(lib, _OP_NT, dhid, w_fc32, t, d, hidden, stream)
    dx, dg, db = _ln_bwd(lib, x2d, dout2d, dh, stats, gamma, stream,
                         param_grads)
    LAUNCHES[name] += 1
    if not param_grads:
        return (dx.view(b, n, d),) + (None,) * 6
    dw_fc = _gemm_bwd(lib, _OP_LN_TN, x2d, dhid, d, hidden, t, stream,
                      stats=stats, gamma=gamma, beta=_f32(ln_bias))
    dw_proj = _gemm_bwd(lib, _OP_GELU_TN, hid, dout2d, hidden, d, t, stream)
    return (dx.view(b, n, d), dg.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dw_fc.to(w_fc.dtype), _colsum(lib, dhid, stream).to(b_fc.dtype),
            dw_proj.to(w_proj.dtype), _colsum(lib, dout2d, stream))


# ---------------------------------------------------------------------------
# autograd: K1/K2 forward, K3/K4 backward
# ---------------------------------------------------------------------------

def _needed(ctx, grads, extra):
    """The gradients autograd asked for, None for the rest, then ``extra``
    Nones for the non-tensor arguments."""
    need = ctx.needs_input_grad
    return tuple(g if need[i] else None for i, g in enumerate(grads)) + (None,) * extra


class _LnAttentionFn(torch.autograd.Function):
    """K1 whose backward is K3. Saves only the primal inputs: qkv, the
    scores and the head outputs are recomputed by K3."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                num_heads, mask):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                              b_out, mask)
        return _ln_attention_forward(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                     w_out, b_out, num_heads, mask)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, mask = ctx.saved_tensors
        grads = ln_attn_bwd(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, mask,
                            ctx.num_heads, g.to(x.dtype).contiguous(),
                            param_grads=any(ctx.needs_input_grad[1:7]))
        dbout = grads[6]
        grads = grads[:6] + (None if dbout is None else dbout.to(b_out.dtype),)
        return _needed(ctx, grads, 2)


class _LnMlpFn(torch.autograd.Function):
    """K2 whose backward is K4. Saves only the primal inputs: the [T, 4D]
    hidden is recomputed by K4."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj)
        return _ln_mlp_forward(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj = ctx.saved_tensors
        grads = ln_mlp_bwd(x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                           g.to(x.dtype).contiguous(),
                           param_grads=any(ctx.needs_input_grad[1:7]))
        dbproj = grads[6]
        grads = grads[:6] + (None if dbproj is None else dbproj.to(b_proj.dtype),)
        return _needed(ctx, grads, 0)


def _tracked(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_ln_attention_block(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                             num_heads: int, mask=None):
    """K1: ``x + MHA(LN(x))`` for x [B, N, D]; weights in right-multiply form
    (w_qkv [D, 3D], w_out [D, D]) and in x's dtype; mask an optional additive
    fp32 [N, N]. Returns [B, N, D] in x's dtype. Differentiable in every
    input but the mask, through K3."""
    d = x.shape[-1]
    name = "fused_ln_attention_block"
    _check_inputs(name, x, {"w_qkv": w_qkv, "w_out": w_out},
                  {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
                   "b_qkv": (b_qkv, 3 * d), "b_out": (b_out, d)}, mask)
    _check_heads(name, x, w_qkv, w_out, num_heads)
    args = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out)
    if _tracked(*args):
        return _LnAttentionFn.apply(*args, num_heads, mask)
    return _ln_attention_forward(*args, num_heads, mask)


def fused_ln_mlp(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """K2: ``x + MLP(LN(x))`` for x [B, N, D]; w_fc [D, 4D] and w_proj [4D, D]
    in x's dtype; biases are used in fp32. Returns [B, N, D] in x's dtype.
    Differentiable in every input, through K4."""
    d = x.shape[-1]
    name = "fused_ln_mlp"
    _check_inputs(name, x, {"w_fc": w_fc, "w_proj": w_proj},
                  {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
                   "b_fc": (b_fc, w_fc.shape[-1]), "b_proj": (b_proj, d)})
    _check_mlp_shapes(name, x, w_fc, w_proj)
    args = (x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj)
    if _tracked(*args):
        return _LnMlpFn.apply(*args)
    return _ln_mlp_forward(*args)
