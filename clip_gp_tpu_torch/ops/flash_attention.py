"""The fused transformer sub-blocks of the CLIP towers, their gradients, and
the two attention building blocks of the JAX package.

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
- ``flash_attention`` (K7) is standalone attention ``softmax(q·kᵀ/√Dh +
  mask)·v`` on ``[B, H, N, Dh]``, replacing ``_attention_kernel``.
- ``fused_attention_block`` (K8) computes ``MHA(h·Wqkv + bqkv)·Wout + bout``
  on an already normed ``h`` (no LN, no residual), replacing
  ``_fused_block_kernel``. Like K1 and K7 it has no caller on the towers'
  path: the JAX package keeps both as tested building blocks and as the
  lineage of its block-level fusion, and so does the port.

On a CUDA tensor each wrapper launches the hand-written kernels of
``clip_gp_tpu_torch/csrc`` (built at first use, see ``_build.py``):
K1 = an LN pass → GEMM (qkv) → attention → GEMM with bias + residual
epilogue; K2 = an LN pass → GEMM with QuickGELU epilogue → GEMM with bias +
residual epilogue (the GEMMs of ``ln_gemm.cu``: bf16 on its own
``mma.sync`` kernel, fp32 on the 3xTF32 core of ``gemm_tf32.cuh``); K3 and
K4 = an fp32 LN pass (LN(x) and its statistics) → the 3xTF32 GEMMs of
``gemm_bwd.cu`` on the same core (transposed operands; bias, QuickGELU and
QuickGELU-derivative epilogues) → the attention backward of
``attention_bwd.cu`` (K3; 3xTF32 on the tensor cores, checked against
``attention_bwd_plain``) → the LN backward and column sums of
``ln_bwd.cu``; K7 = the attention core of ``attention.cu`` reading
contiguous heads; K8 = GEMM with a bias epilogue (qkv) → K1's attention
core → GEMM with a bias epilogue. In this version the qkv and hidden
intermediates pass through device memory. On a CPU tensor the wrapper runs
the plain PyTorch version beside it (``ln_attention_block_plain``,
``ln_mlp_plain``, ``ln_attn_bwd_plain``, ``ln_mlp_bwd_plain``,
``attention_plain``, ``attention_block_plain``), which rounds where the
Pallas kernel rounds.
There is no other route: a CUDA tensor never reaches the plain version
through a wrapper. So the JAX package's ``use_flash`` (Pallas on a TPU,
eager math elsewhere, and its ``CLIP_GP_TPU_DISABLE_FLASH`` opt-out) has
no counterpart here.

K1 and K2 take fp32 or bf16 activations (the frozen encodes of the training
path run in fp32) and head width 64. K1's attention core routes by the
sequence length N: up to ``MAX_TOKENS`` (256: ViT-B/16's 197 tokens,
ViT-B/32's 50, the text tower's 77) the exact strip kernel, which holds a
strip's scores over all keys in registers; above it, in fp32 only, the
key-tiled core (ViT-L/14@336px's 577 tokens), which streams K and V in tiles
of ``KEY_TILE`` keys with an online softmax (``attention_key_tiled_plain``
is its plain version). Above 256 tokens K1 refuses bf16, whose
probabilities would round before they are normalised, and a gradient,
since K3's attention backward holds every key of a head; K2 and K4 take any
N. K1 and K2 are differentiable: when autograd needs their gradient they
run as ``torch.autograd.Function``s whose backward is K3/K4. The Function
saves only the block's primal inputs and the backward recomputes the rest,
as the TPU kernels do and as the JAX towers' per-block ``jax.checkpoint``
does. The weight gradients are computed only when autograd asks for them.
What bounds each kernel on an H100 is stated at the top of its CUDA source.

K7 takes head widths 32 and 64 and is not differentiable, as the Pallas
kernel has no JVP: a call with autograd on and an input that needs a
gradient raises. K8 is differentiable in every input but the mask: its
backward is the VJP of the eager math (``attention_block_xla``) recomputed
from the saved inputs, as the JAX package's custom VJP is. The JAX package
has no backward kernel for K8, so neither has the port; that backward is
the port of the JAX one, not a fallback.

``LAUNCHES`` counts each wrapper's kernel launches (one per call on a CUDA
tensor), so a run can show that its encodes went through the kernels;
``key_tiled_attention`` counts the K1 calls whose attention took the
key-tiled core (also counted under ``fused_ln_attention_block``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from clip_gp_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {
    "fused_ln_attention_block": 0, "fused_ln_mlp": 0,
    "ln_attn_bwd": 0, "ln_mlp_bwd": 0,
    "flash_attention": 0, "fused_attention_block": 0,
    "key_tiled_attention": 0,
}

HEAD_DIM = 64
# the head widths K7 takes
ATTENTION_HEAD_DIMS = (32, 64)
# the most tokens of the exact strip kernel of csrc/attention.cu: K3, K5, K7,
# K8 and a bf16 K1 take no more; an fp32 K1 takes the key-tiled core above
MAX_TOKENS = 256
# keys of a tile of the key-tiled core (csrc/attention.cu's TK)
KEY_TILE = 64
LN_EPS = 1e-5

# C-side enums of csrc/common.cuh, csrc/ln_gemm.cu and csrc/gemm_bwd.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_EPI_QKV, _EPI_GELU, _EPI_RESID_ATTN, _EPI_RESID_MLP, _EPI_BIAS = range(5)
# their names, as gemm_plain takes them
GEMM_EPILOGUES = ("qkv", "gelu", "resid_attn", "resid_mlp", "bias")
# backward products (gemm_bwd.cu): N = A·B, T = the operand read transposed
_GEMM_BWD_PRODUCTS = {"nn_bias": 0, "nt": 1, "nt_gelu_bwd": 2, "tn": 3}
# the six products of K3 and K4, as gemm_bwd_plain names them, and the
# product of gemm_bwd.cu each runs once its A has been written: LN(x) by
# _ln_f32, QuickGELU(hid_pre) by K4's hid_pre product
GEMM_BWD_OPS = {"ln_nn_bias": "nn_bias", "nt": "nt", "nt_gelu_bwd": "nt_gelu_bwd",
                "ln_tn": "tn", "tn": "tn", "gelu_tn": "tn"}
# the output tiles of the 3xTF32 core (gemm_tf32.cuh's GemmTile) -> (rows,
# columns, rate relative to 128x128, fitted to the "[gemm tiles]" and
# "[gemm_bwd tiles]" timings that chip_smoke.py prints on an H100: over two
# runs' 24 forward and dx products each, the picks lose 0.9% to the fastest
# shape on average)
_TILE_128, _TILE_64, _TILE_128X64 = range(3)
_TILES = {_TILE_128: (128, 128, 1.0), _TILE_128X64: (128, 64, 0.93),
          _TILE_64: (64, 64, 0.89)}
# rows per block of the first pass of a column sum (ln_bwd.cu)
_COLSUM_ROWS = 64


def reset_launch_counts() -> None:
    _build.reset_counts(LAUNCHES)


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


def attention_plain(q, k, v, mask=None, mm=_mm):
    """Plain PyTorch K7, rounding where ``_attention_kernel`` and its wrapper
    round: q [B, H, N, Dh] is scaled by 1/√Dh in its dtype (the factor
    rounded to it, as JAX casts a Python scalar), scores accumulate in fp32
    with the fp32 mask added, the fp32 softmax's probabilities round to the
    working type, and p·v accumulates in fp32 and rounds to it. ``mm``
    computes the two products; a test passes an emulation of the card's
    arithmetic."""
    dt = q.dtype
    q = q * torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=dt, device=q.device)
    scores = mm(q, k.transpose(-1, -2))
    if mask is not None:
        scores = scores + mask.float()
    scores = scores - scores.amax(-1, keepdim=True)
    weights = scores.exp()
    weights = weights / weights.sum(-1, keepdim=True)
    return mm(weights.to(dt), v).to(dt)


def attention_key_tiled_plain(q, k, v, mask=None, mm=_mm, key_tile=KEY_TILE):
    """Plain PyTorch version of the key-tiled core of ``csrc/attention.cu``
    (fp32), in the order it reduces: q [B, H, N, Dh] scaled as in
    ``attention_plain``; the keys in tiles of ``key_tile``, in order; per
    query row a running max m, a running sum l and fp32 accumulators o, each
    tile's scores (the mask added) exponentiated against the new max and the
    old l and o rescaled by exp(m_old - m_new) (against 0 while every key so
    far is masked); o / l at the end. ``mm`` as in ``attention_plain``."""
    dt = q.dtype
    q = q * torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=dt, device=q.device)
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), device=q.device)
    l = torch.zeros(shape, device=q.device)
    o = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, k.shape[-2], key_tile):
        s = mm(q, k[..., k0:k0 + key_tile, :].transpose(-1, -2))
        if mask is not None:
            s = s + mask[:, k0:k0 + key_tile].float()
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = (m - base).exp()
        p = (s - base).exp()
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, v[..., k0:k0 + key_tile, :])
        m = m_new
    return (o / l).to(dt)


def _mha_plain(h, w_qkv, b_qkv, num_heads, mask, mm):
    """The heads' attention output [B, N, D] in h's dtype, as
    ``_qkv_heads_accumulate`` computes it before the out-projection: qkv =
    T(T(h·Wqkv) + T(bqkv)), then ``attention_plain`` per head."""
    dt = h.dtype
    b, n, d = h.shape
    qkv = mm(h, w_qkv.to(dt)).to(dt) + b_qkv.to(dt)
    q, k, v = (
        t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)
        for t in qkv.split(d, dim=-1)
    )
    return attention_plain(q, k, v, mask, mm).transpose(1, 2).reshape(b, n, d)


def ln_attention_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                             num_heads: int, mask=None, mm=_mm):
    """Plain PyTorch K1, rounding where ``_fused_ln_block_kernel`` rounds:
    h, qkv (before and after adding b_qkv, itself rounded), the scaled q,
    the probabilities and each head's output round to ``x.dtype``; the
    out-projection sums the heads in fp32 and adds the residual and b_out in
    fp32. ``mm`` computes the four products (two GEMMs, and the two of the
    attention core), as in ``attention_plain``."""
    dt = x.dtype
    x32 = x.float()
    h = layer_norm_f32(x32, ln_scale, ln_bias).to(dt)
    attn = _mha_plain(h, w_qkv, b_qkv, num_heads, mask, mm)
    return (x32 + mm(attn, w_out.to(dt)) + b_out.float()).to(dt)


def attention_block_plain(h, w_qkv, b_qkv, w_out, b_out, num_heads: int,
                          mask=None, mm=_mm):
    """Plain PyTorch K8, rounding where ``_fused_block_kernel`` and its
    wrapper round: qkv and the heads as in K1 (without LN), the
    out-projection summed over the heads in fp32 and rounded to ``h.dtype``,
    and only then b_out, rounded to it, added in it. ``mm`` as in
    ``ln_attention_block_plain``."""
    dt = h.dtype
    attn = _mha_plain(h, w_qkv, b_qkv, num_heads, mask, mm)
    return mm(attn, w_out.to(dt)).to(dt) + b_out.to(dt)


def attention_block_xla(h, w_qkv, b_qkv, w_out, b_out, num_heads: int,
                        mask=None):
    """The eager math of K8, as the JAX package's ``_xla_attention_block``:
    every product in h's dtype, the scores divided by √Dh and the mask added
    in it, the softmax in fp32. K8's backward differentiates this."""
    dt = h.dtype
    b, n, d = h.shape
    dh = d // num_heads
    qkv = h @ w_qkv.to(dt) + b_qkv.to(dt)
    q, k, v = (
        t.reshape(b, n, num_heads, dh).transpose(1, 2)
        for t in qkv.split(d, dim=-1)
    )
    root = torch.tensor(dh ** 0.5, dtype=torch.float32, device=h.device).to(dt)
    scores = q @ k.transpose(-1, -2) / root
    if mask is not None:
        scores = scores + mask.to(dt)
    weights = torch.softmax(scores.float(), dim=-1).to(dt)
    attn = (weights @ v).transpose(1, 2).reshape(b, n, d)
    return attn @ w_out.to(dt) + b_out.to(dt)


def quick_gelu(h):
    """CLIP's QuickGELU, h·σ(1.702·h)."""
    return h * torch.sigmoid(1.702 * h)


def ln_mlp_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, mm=_mm):
    """Plain PyTorch K2, rounding where ``_fused_mlp_kernel`` rounds: h and the
    QuickGELU output round to ``x.dtype``; biases, GELU and the residual are
    fp32. ``mm`` computes the two products, as in ``attention_plain``."""
    dt = x.dtype
    x32 = x.float()
    h = layer_norm_f32(x32, ln_scale, ln_bias).to(dt)
    hid = quick_gelu(mm(h, w_fc.to(dt)) + b_fc.float())
    out = mm(hid.to(dt), w_proj.to(dt)) + b_proj.float()
    return (x32 + out).to(dt)


def gemm_plain(a, w, bias, epilogue: str, resid=None, ln_scale=None,
               ln_bias=None):
    """Plain PyTorch version of one product of ``csrc/ln_gemm.cu``, the GEMM
    inside K1, K2 and K8: ``epilogue(prologue(a) @ w)`` on a [M, K] and w
    [K, N] of one working type T, with an fp32 bias [N]. The LN prologue of
    "qkv" and "gelu" (``ln_scale``/``ln_bias`` given) rounds LN(a) to T;
    the product sums in fp32; the epilogue (``GEMM_EPILOGUES``) is fp32 and
    rounds once to T: "qkv" and "bias" T(T(acc) + b), "gelu"
    QuickGELU(acc + b), "resid_attn" (r + acc) + b, "resid_mlp"
    r + (acc + b), r = ``resid`` [M, N]."""
    dt = a.dtype
    if epilogue in ("qkv", "gelu"):
        a = layer_norm_f32(a, ln_scale, ln_bias).to(dt)
    acc = _mm(a, w)
    b = bias.float()
    if epilogue in ("qkv", "bias"):
        out = acc.to(dt).float() + b
    elif epilogue == "gelu":
        out = quick_gelu(acc + b)
    elif epilogue == "resid_attn":
        out = (resid.float() + acc) + b
    elif epilogue == "resid_mlp":
        out = resid.float() + (acc + b)
    else:
        raise ValueError(f"unknown GEMM epilogue {epilogue!r}")
    return out.to(dt)


def gemm_bwd_plain(op: str, a, b, bias=None, aux=None, ln_scale=None,
                   ln_bias=None):
    """Plain PyTorch version of one of the six products of K3 and K4
    (``GEMM_BWD_OPS``), in fp32 on upcast operands as ``ln_attn_bwd_plain``
    and ``ln_mlp_bwd_plain`` compute them: "ln_nn_bias" LN(a)·b + bias (a = x
    [M, K], b [K, N]); "nt" a·bᵀ (a [M, K], b [N, K]); "nt_gelu_bwd"
    (a·bᵀ)·QuickGELU′(aux) (aux = hid_pre [M, N]); "ln_tn" LN(a)ᵀ·b (a = x
    [K, M], b [K, N]); "tn" aᵀ·b; "gelu_tn" QuickGELU(a)ᵀ·b (a = hid_pre
    [K, M]). LN is over a's rows with ``ln_scale``/``ln_bias``."""
    if op not in GEMM_BWD_OPS:
        raise ValueError(f"unknown backward product {op!r}")
    a, b = a.float(), b.float()
    if op in ("ln_nn_bias", "ln_tn"):
        a = layer_norm_f32(a, ln_scale, ln_bias)
    elif op == "gelu_tn":
        a = quick_gelu(a)
    if GEMM_BWD_OPS[op] == "tn":
        return a.T @ b
    if op == "ln_nn_bias":
        return a @ b + bias.float()
    out = a @ b.T
    if op == "nt_gelu_bwd":
        s = torch.sigmoid(1.702 * aux)
        out = out * (s + 1.702 * aux * s * (1.0 - s))
    return out


def _ln_backward(dout32, dh, rstd, xhat, ln_scale):
    """(dx fp32, dγ, dβ) from the gradient ``dh`` at the LN output."""
    rows = tuple(range(dh.dim() - 1))
    dg = (dh * xhat).sum(rows)
    db = dh.sum(rows)
    dxhat = dh * ln_scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return dout32 + rstd * (dxhat - m1 - xhat * m2), dg, db


def attention_bwd_plain(qkv, d_attn, mask, num_heads: int, mm=torch.matmul):
    """Plain PyTorch attention-core backward of K3 (what ``attention_bwd.cu``
    computes), following the per-head loop of ``_ln_attn_bwd_kernel`` in
    fp32: from qkv [B, N, 3D] and the gradient d_attn [B, N, D] at the heads'
    outputs, returns (dqkv [B, N, 3D], the head outputs attn [B, N, D]).
    ``mm`` computes the six products (S, O, dP, dv, dq, dk); a test passes
    an emulation of the card's arithmetic."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    dh = d // num_heads
    inv = 1.0 / dh**0.5

    def heads(t):  # [B, N, D] -> [B, H, N, dh]
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    def merge(t):  # [B, H, N, dh] -> [B, N, D]
        return t.transpose(1, 2).reshape(b, n, d)

    q, k, v = (heads(t) for t in qkv.float().split(d, dim=-1))
    q_s = q * inv
    scores = mm(q_s, k.transpose(-1, -2))
    if mask is not None:
        scores = scores + mask.float()
    scores = scores - scores.amax(-1, keepdim=True)
    w = scores.exp()
    a = w / w.sum(-1, keepdim=True)
    out_h = mm(a, v)
    d_outh = heads(d_attn.float())
    da = mm(d_outh, v.transpose(-1, -2))
    dv = mm(a.transpose(-1, -2), d_outh)
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dq = mm(ds, k) * inv
    dk = mm(ds.transpose(-1, -2), q_s)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1), merge(out_h)


def ln_attn_bwd_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, mask,
                      num_heads: int, dout, mm=torch.matmul,
                      attn_mm=torch.matmul):
    """Plain PyTorch K3, following ``_ln_attn_bwd_kernel``: every input is
    upcast to fp32 and the block is recomputed in fp32 (for a bf16 ``x`` this
    is an fp32 recompute, not the bf16 forward). Returns (dx in x.dtype, dγ,
    dβ, dWqkv, dbqkv, dWout, dbout): each gradient in its input's dtype,
    except dbout, which stays fp32 (the Pallas call site casts it). ``mm``
    computes the five products that gemm_bwd.cu runs (qkv, d_attn, dh,
    dWqkv, dWout), ``attn_mm`` the six of the attention core
    (``attention_bwd_plain``); a test passes emulations of the card's
    arithmetic."""
    b, n, d = x.shape
    rstd, xhat, h = _ln_recompute(x, ln_scale, ln_bias)
    dout32 = dout.float()
    w_qkv32, w_out32 = w_qkv.float(), w_out.float()
    qkv = mm(h, w_qkv32) + b_qkv.float()
    dqkv, out = attention_bwd_plain(qkv, mm(dout32, w_out32.T), mask,
                                    num_heads, mm=attn_mm)
    rows = (0, 1)
    dwqkv = mm(h.reshape(-1, d).T, dqkv.reshape(-1, 3 * d))
    dwout = mm(out.reshape(-1, d).T, dout32.reshape(-1, d))
    dx, dg, db = _ln_backward(dout32, mm(dqkv, w_qkv32.T), rstd, xhat, ln_scale)
    return (dx.to(x.dtype), dg.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dwqkv.to(w_qkv.dtype), dqkv.sum(rows).to(b_qkv.dtype),
            dwout.to(w_out.dtype), dout32.sum(rows))


def ln_mlp_bwd_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, dout,
                     mm=torch.matmul):
    """Plain PyTorch K4, following ``_ln_mlp_bwd_kernel``: an fp32 recompute
    of LN, the hidden and QuickGELU, then every gradient. Returns (dx in
    x.dtype, dγ, dβ, dWfc, dbfc, dWproj, dbproj): each gradient in its
    input's dtype, except dbproj, which stays fp32 (the Pallas call site
    casts it). ``mm`` computes the five products that gemm_bwd.cu runs, as
    in ``ln_attn_bwd_plain``."""
    d = x.shape[-1]
    rstd, xhat, h = _ln_recompute(x, ln_scale, ln_bias)
    dout32 = dout.float()
    w_fc32, w_proj32 = w_fc.float(), w_proj.float()
    hid_pre = mm(h, w_fc32) + b_fc.float()
    s = torch.sigmoid(1.702 * hid_pre)
    act = hid_pre * s
    dact = mm(dout32, w_proj32.T)
    dhid = dact * (s + 1.702 * hid_pre * s * (1.0 - s))
    rows = tuple(range(x.dim() - 1))
    dwproj = mm(act.reshape(-1, act.shape[-1]).T, dout32.reshape(-1, d))
    dwfc = mm(h.reshape(-1, d).T, dhid.reshape(-1, dhid.shape[-1]))
    dx, dg, db = _ln_backward(dout32, mm(dhid, w_fc32.T), rstd, xhat, ln_scale)
    return (dx.to(x.dtype), dg.to(ln_scale.dtype), db.to(ln_bias.dtype),
            dwfc.to(w_fc.dtype), dhid.sum(rows).to(b_fc.dtype),
            dwproj.to(w_proj.dtype), dout32.sum(rows))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_inputs(name, x, weights, vectors, mask=None, max_tokens=MAX_TOKENS):
    """Shared checks of the wrappers; raises on anything the kernels do not
    take. ``vectors`` maps each 1-D input's name to ``(tensor, expected
    length)``; ``max_tokens`` is the most tokens the wrapper takes (None: any
    number)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, N, D] tensor")
    if max_tokens is not None and x.shape[1] > max_tokens:
        raise ValueError(f"{name}: needs N <= {max_tokens}, got {tuple(x.shape)}")
    if x.shape[2] % 8:
        raise ValueError(f"{name}: needs D % 8 == 0, got {tuple(x.shape)}")
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
    _check_mask(name, mask, x.shape[1], tensors)
    _check_devices(name, x, tensors)


def _check_mask(name, mask, n, tensors):
    """Refuses a mask that is not a contiguous [N, N] or that needs a
    gradient; appends it to ``tensors``."""
    if mask is None:
        return
    if tuple(mask.shape) != (n, n) or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be contiguous [N, N]")
    if torch.is_grad_enabled() and mask.requires_grad:
        raise RuntimeError(f"{name}: the kernels give no gradient for the mask")
    tensors.append(mask)


def _check_devices(name, x, tensors):
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_attention(name, q, k, v, mask):
    """K7's checks: q, k and v contiguous [B, H, N, Dh] of one dtype, Dh 32
    or 64, 1 <= N <= 256, no input that needs a gradient."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be a contiguous [B, H, N, Dh] tensor")
    for key, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous {q.dtype} "
                             f"tensor of q's shape {tuple(q.shape)}")
    n, dh = q.shape[2], q.shape[3]
    if dh not in ATTENTION_HEAD_DIMS:
        raise ValueError(f"{name}: head width Dh must be 32 or 64, got {dh}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"{name}: needs 1 <= N <= {MAX_TOKENS}, got N={n}")
    tensors = [q, k, v]
    _check_mask(name, mask, n, tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: no gradient, as the Pallas kernel has no "
                           "JVP; call it under torch.no_grad()")
    _check_devices(name, q, tensors)


def _check_k1_tokens(name, x, tracked):
    """K1 past ``MAX_TOKENS`` tokens: only the key-tiled core, in fp32 and
    without a gradient."""
    n = x.shape[1]
    if n <= MAX_TOKENS:
        return
    if x.dtype != torch.float32:
        raise ValueError(
            f"{name}: needs N <= {MAX_TOKENS} in {x.dtype}, got N={n}: above it only "
            "the fp32 key-tiled core runs (in bf16 its probabilities would round "
            "before they are normalised)")
    if tracked:
        raise ValueError(
            f"{name}: needs N <= {MAX_TOKENS} for a gradient, got N={n}: K3's "
            "attention backward holds every key of a head")


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


@_build.on_tensor_device
def _attention(lib, qkv, mask, attn, b, n, num_heads, d, stream):
    """The attention core of K1 and K8: qkv [B·N, 3D] -> attn [B·N, D], by
    the strip kernel up to ``MAX_TOKENS`` tokens, else (fp32; only K1 takes
    such N) by the key-tiled core, counted in ``LAUNCHES``."""
    mask32 = None if mask is None else _f32(mask)
    tiled = n > MAX_TOKENS
    entry = lib.cgt_attention_tiled if tiled else lib.cgt_attention
    _build.check(
        entry(_ptr(qkv), _ptr(mask32), _ptr(attn), b, n, num_heads, d,
              _DTYPE_CODE[qkv.dtype], stream),
        "attention_tiled" if tiled else "attention",
    )
    if tiled:
        _build.count_launch(LAUNCHES, "key_tiled_attention")


@_build.on_tensor_device
def _attention_bwd(lib, qkv, d_attn, mask, b, n, num_heads, d, stream,
                   with_attn):
    """The attention-core backward of K3 (``attention_bwd.cu``): fp32 qkv
    [B·N, 3D] and d_attn [B·N, D] -> (dqkv [B·N, 3D], the head outputs
    [B·N, D] if ``with_attn`` else None)."""
    dqkv = torch.empty(b * n, 3 * d, dtype=torch.float32, device=qkv.device)
    attn = (torch.empty(b * n, d, dtype=torch.float32, device=qkv.device)
            if with_attn else None)
    # the row statistics between the two launches past 80 tokens
    row_stats = (torch.empty(b * n * num_heads, 3, dtype=torch.float32,
                             device=qkv.device) if n > 80 else None)
    mask32 = None if mask is None else _f32(mask)
    _build.check(
        lib.cgt_attention_bwd(_ptr(qkv), _ptr(d_attn), _ptr(mask32),
                              _ptr(dqkv), _ptr(attn), _ptr(row_stats), b, n,
                              num_heads, d, stream),
        "attention_bwd",
    )
    return dqkv, attn


@_build.on_tensor_device
def _gemm(lib, a, w, bias, out, epilogue, stream, resid=None, tile=None):
    """One product of ``ln_gemm.cu`` into ``out``: ``a`` [M, K] read as is
    (the qkv and c_fc products take LN(x) from ``_ln_input``). fp32 runs the
    3xTF32 core of gemm_tf32.cuh on the tile shape ``_tile_plan`` picks
    unless ``tile`` gives it; bf16 has one tile shape."""
    m, k = a.shape
    n = w.shape[1]
    if tile is None:
        tile = (_tile_plan(m, n, _sm_count(a.device.index or 0))
                if a.dtype == torch.float32 else _TILE_128)
    _build.check(
        lib.cgt_gemm(_ptr(a), _ptr(w), _ptr(bias), _ptr(resid), _ptr(out), m, n,
                     k, _DTYPE_CODE[a.dtype], epilogue, tile, stream),
        "ln_gemm",
    )


@_build.on_tensor_device
def _ln_input(lib, x2d, gamma, beta, stream):
    """LN(x) [rows, D] in x's dtype, the A of the qkv and c_fc products, in a
    pass of its own: fp32 by ``_ln_f32``; bf16 by the row statistics, then
    ``cgt_ln_apply``, which rounds once to bf16."""
    if x2d.dtype == torch.float32:
        return _ln_f32(lib, x2d, gamma, beta, stream)[1]
    rows, cols = x2d.shape
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x2d.device)
    _build.check(lib.cgt_ln_stats(_ptr(x2d), _ptr(stats), rows, cols, stream),
                 "ln_stats")
    h = torch.empty_like(x2d)
    _build.check(lib.cgt_ln_apply(_ptr(x2d), _ptr(stats), _ptr(gamma),
                                  _ptr(beta), _ptr(h), rows, cols, stream),
                 "ln_apply")
    return h


@_build.on_tensor_device
def _ln_f32(lib, x2d, gamma, beta, stream):
    """(row statistics [rows, 2], LN(x) [rows, D] fp32), in one pass: the
    statistics for the LN backward, LN(x) for the products of K3 and K4
    that take it as A."""
    rows = x2d.shape[0]
    stats = torch.empty(rows, 2, dtype=torch.float32, device=x2d.device)
    h = torch.empty(x2d.shape, dtype=torch.float32, device=x2d.device)
    _build.check(
        lib.cgt_ln_f32(_ptr(x2d), _ptr(gamma), _ptr(beta), _ptr(stats), _ptr(h),
                       rows, x2d.shape[1], _DTYPE_CODE[x2d.dtype], stream),
        "ln_f32",
    )
    return stats, h


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _tile_plan(m: int, n: int, sms: int) -> int:
    """The tile shape of an unsplit product of the 3xTF32 core with an
    [m, n] output on a card of ``sms`` SMs, for the forward products of
    ln_gemm.cu and all but the weight gradients of gemm_bwd.cu: the shape
    whose busiest SM has the least work (its blocks times their area over
    the shape's rate: smaller blocks load and split more fragments for each
    product), the larger shape on a tie."""
    def busiest(tile):
        bm, bn, rate = _TILES[tile]
        return -(-(-(-m // bm) * -(-n // bn)) // sms) * bm * bn / rate

    return min(_TILES, key=busiest)


def _gemm_bwd_plan(m: int, n: int, k: int, product: str, sms: int):
    """(tile, splits) of one product of gemm_bwd.cu on a card of ``sms``
    SMs. A "tn" product (a weight gradient: K = T rows, few output tiles)
    takes 128x128 tiles and splits K until about two blocks an SM are busy,
    each split at least 256 rows. Any other product takes ``_tile_plan``'s
    shape, unsplit."""
    if product == "tn":
        tiles = -(-m // 128) * -(-n // 128)
        return _TILE_128, max(1, min(16, 2 * sms // tiles, k // 256))
    return _tile_plan(m, n, sms), 1


@_build.on_tensor_device
def _gemm_bwd(lib, product, a, b, m, n, k, stream, bias=None, aux=None,
              act=None, plan=None):
    """One fp32 product of gemm_bwd.cu (``_GEMM_BWD_PRODUCTS``), returned as
    a new fp32 [m, n] tensor. The product's io operand (A of "nt" and
    "nt_gelu_bwd", B of "tn") may be bf16; every other operand is fp32.
    "nn_bias" adds ``bias`` and, given ``act``, writes QuickGELU of its
    output there too; "nt_gelu_bwd" multiplies by QuickGELU′(``aux``). The
    tile and the split of K come from ``_gemm_bwd_plan`` unless ``plan``
    gives them; split parts are summed in a second pass, in a fixed order."""
    io = b if product == "tn" else a
    tile, splits = plan or _gemm_bwd_plan(m, n, k, product,
                                          _sm_count(a.device.index or 0))
    out = torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
    _build.check(
        lib.cgt_gemm_bwd(_ptr(a), _ptr(b), _ptr(bias), _ptr(aux), _ptr(out),
                         _ptr(act), m, n, k, splits, _DTYPE_CODE[io.dtype],
                         _GEMM_BWD_PRODUCTS[product], tile, stream),
        "gemm_bwd",
    )
    if splits == 1:
        return out[0]
    total = torch.empty(m, n, dtype=torch.float32, device=a.device)
    _build.check(lib.cgt_sum_parts(_ptr(out), _ptr(total), splits, m * n, stream),
                 "sum_parts")
    return total


@_build.on_tensor_device
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


@_build.on_tensor_device
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
    h = _ln_input(lib, x2d, _f32(ln_scale), _f32(ln_bias), stream)
    # the Pallas wrapper casts b_qkv to the working type, b_out to fp32
    _gemm(lib, h, w_qkv, _f32(b_qkv.to(x.dtype)), qkv, _EPI_QKV, stream)
    _attention(lib, qkv, mask, attn, b, n, num_heads, d, stream)
    _gemm(lib, attn, w_out, _f32(b_out), out.view(b * n, d), _EPI_RESID_ATTN,
          stream, resid=x2d)
    _build.count_launch(LAUNCHES, "fused_ln_attention_block")
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
    h = _ln_input(lib, x2d, _f32(ln_scale), _f32(ln_bias), stream)
    _gemm(lib, h, w_fc, _f32(b_fc), hid, _EPI_GELU, stream)
    _gemm(lib, hid, w_proj, _f32(b_proj), out.view(b * n, d), _EPI_RESID_MLP,
          stream, resid=x2d)
    _build.count_launch(LAUNCHES, "fused_ln_mlp")
    return out


# ---------------------------------------------------------------------------
# K7 and K8
# ---------------------------------------------------------------------------

@_build.on_tensor_device
def flash_attention(q, k, v, mask=None):
    """K7: ``softmax(q·kᵀ/√Dh + mask)·v`` for contiguous q, k, v [B, H, N,
    Dh] of one dtype (fp32 or bf16), Dh 32 or 64, N <= 256; mask an optional
    additive [N, N], used in fp32. Returns [B, H, N, Dh] in q's dtype. Not
    differentiable: raises on an input that needs a gradient."""
    name = "flash_attention"
    _check_attention(name, q, k, v, mask)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask)
    b, h, n, dh = q.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    mask32 = None if mask is None else _f32(mask)
    _build.check(
        lib.cgt_attention_bhnd(_ptr(q), _ptr(k), _ptr(v), _ptr(mask32),
                               _ptr(out), b, n, h, dh, _DTYPE_CODE[q.dtype],
                               stream),
        "attention_bhnd",
    )
    _build.count_launch(LAUNCHES, name)
    return out


def _attention_block_forward(h, w_qkv, b_qkv, w_out, b_out, num_heads, mask):
    if h.device.type == "cpu":
        return attention_block_plain(h, w_qkv, b_qkv, w_out, b_out, num_heads,
                                     mask)
    b, n, d = h.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    h2d = h.view(b * n, d)
    qkv = torch.empty(b * n, 3 * d, dtype=h.dtype, device=h.device)
    attn = torch.empty(b * n, d, dtype=h.dtype, device=h.device)
    out = torch.empty_like(h)
    # the Pallas wrapper adds both biases in the working type
    _gemm(lib, h2d, w_qkv, _f32(b_qkv.to(h.dtype)), qkv, _EPI_BIAS, stream)
    _attention(lib, qkv, mask, attn, b, n, num_heads, d, stream)
    _gemm(lib, attn, w_out, _f32(b_out.to(h.dtype)), out.view(b * n, d),
          _EPI_BIAS, stream)
    _build.count_launch(LAUNCHES, "fused_attention_block")
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
    stats, h = _ln_f32(lib, x2d, gamma, _f32(ln_bias), stream)
    qkv = _gemm_bwd(lib, "nn_bias", h, w_qkv32, t, 3 * d, d, stream,
                    bias=_f32(b_qkv))
    d_attn = _gemm_bwd(lib, "nt", dout2d, _f32(w_out), t, d, d, stream)
    dqkv, attn = _attention_bwd(lib, qkv, d_attn, mask, b, n, num_heads, d,
                                stream, param_grads)
    dh = _gemm_bwd(lib, "nt", dqkv, w_qkv32, t, d, 3 * d, stream)
    dx, dg, db = _ln_bwd(lib, x2d, dout2d, dh, stats, gamma, stream,
                         param_grads)
    _build.count_launch(LAUNCHES, name)
    if not param_grads:
        return (dx.view(b, n, d),) + (None,) * 6
    dw_qkv = _gemm_bwd(lib, "tn", h, dqkv, d, 3 * d, t, stream)
    dw_out = _gemm_bwd(lib, "tn", attn, dout2d, d, d, t, stream)
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
                   "b_fc": (b_fc, hidden)}, max_tokens=None)
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
    stats, h = _ln_f32(lib, x2d, gamma, _f32(ln_bias), stream)
    # QuickGELU(hid_pre), dWproj's A, written beside hid_pre
    act = (torch.empty(t, hidden, dtype=torch.float32, device=x.device)
           if param_grads else None)
    hid = _gemm_bwd(lib, "nn_bias", h, w_fc32, t, hidden, d, stream,
                    bias=_f32(b_fc), act=act)
    dhid = _gemm_bwd(lib, "nt_gelu_bwd", dout2d, _f32(w_proj), t, hidden, d,
                     stream, aux=hid)
    dh = _gemm_bwd(lib, "nt", dhid, w_fc32, t, d, hidden, stream)
    dx, dg, db = _ln_bwd(lib, x2d, dout2d, dh, stats, gamma, stream,
                         param_grads)
    _build.count_launch(LAUNCHES, name)
    if not param_grads:
        return (dx.view(b, n, d),) + (None,) * 6
    dw_fc = _gemm_bwd(lib, "tn", h, dhid, d, hidden, t, stream)
    dw_proj = _gemm_bwd(lib, "tn", act, dout2d, hidden, d, t, stream)
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
    input but the mask, through K3, up to ``MAX_TOKENS`` tokens; above them
    fp32 only and without a gradient (the key-tiled core)."""
    d = x.shape[-1]
    name = "fused_ln_attention_block"
    _check_inputs(name, x, {"w_qkv": w_qkv, "w_out": w_out},
                  {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
                   "b_qkv": (b_qkv, 3 * d), "b_out": (b_out, d)}, mask,
                  max_tokens=None)
    _check_heads(name, x, w_qkv, w_out, num_heads)
    args = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out)
    tracked = _tracked(*args)
    _check_k1_tokens(name, x, tracked)
    if tracked:
        return _LnAttentionFn.apply(*args, num_heads, mask)
    return _ln_attention_forward(*args, num_heads, mask)


def fused_ln_mlp(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """K2: ``x + MLP(LN(x))`` for x [B, N, D]; w_fc [D, 4D] and w_proj [4D, D]
    in x's dtype; biases are used in fp32. Returns [B, N, D] in x's dtype.
    Differentiable in every input, through K4. Any N: it has no attention."""
    d = x.shape[-1]
    name = "fused_ln_mlp"
    _check_inputs(name, x, {"w_fc": w_fc, "w_proj": w_proj},
                  {"ln_scale": (ln_scale, d), "ln_bias": (ln_bias, d),
                   "b_fc": (b_fc, w_fc.shape[-1]), "b_proj": (b_proj, d)},
                  max_tokens=None)
    _check_mlp_shapes(name, x, w_fc, w_proj)
    args = (x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj)
    if _tracked(*args):
        return _LnMlpFn.apply(*args)
    return _ln_mlp_forward(*args)


class _AttentionBlockFn(torch.autograd.Function):
    """K8 whose backward is the VJP of ``attention_block_xla``, recomputed
    from the saved primal inputs (the JAX package's ``_fused_block_bwd``).
    The mask gets no gradient."""

    @staticmethod
    def forward(ctx, h, w_qkv, b_qkv, w_out, b_out, num_heads, mask):
        ctx.num_heads = num_heads
        ctx.save_for_backward(h, w_qkv, b_qkv, w_out, b_out, mask)
        return _attention_block_forward(h, w_qkv, b_qkv, w_out, b_out,
                                        num_heads, mask)

    @staticmethod
    def backward(ctx, g):
        *primals, mask = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(primals, need)]
        with torch.enable_grad():
            out = attention_block_xla(*inputs, ctx.num_heads, mask)
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def fused_attention_block(h, w_qkv, b_qkv, w_out, b_out, num_heads: int,
                          mask=None):
    """K8: ``MHA(h·Wqkv + bqkv)·Wout + bout`` for an already normed h [B, N,
    D] (the caller adds the residual); weights in right-multiply form (w_qkv
    [D, 3D], w_out [D, D]) and in h's dtype (a weight of another dtype is
    refused); biases are used in h's dtype; mask an optional additive
    [N, N]. Returns [B, N, D] in h's dtype. Differentiable in every input but
    the mask, through the eager math's VJP."""
    d = h.shape[-1]
    name = "fused_attention_block"
    _check_inputs(name, h, {"w_qkv": w_qkv, "w_out": w_out},
                  {"b_qkv": (b_qkv, 3 * d), "b_out": (b_out, d)}, mask)
    _check_heads(name, h, w_qkv, w_out, num_heads)
    args = (h, w_qkv, b_qkv, w_out, b_out)
    if _tracked(*args):
        return _AttentionBlockFn.apply(*args, num_heads, mask)
    return _attention_block_forward(*args, num_heads, mask)
