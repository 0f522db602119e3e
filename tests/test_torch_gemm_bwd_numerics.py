"""The arithmetic of the fp32 GEMM core that K3 and K4 run
(``clip_gp_tpu_torch/csrc/gemm_tf32.cuh``, launched by ``gemm_bwd.cu``),
emulated on the CPU.

Every product of the backward kernels (qkv, d_attn, dh and the two weight
gradients of K3; hid_pre, dhid, dh and the two weight gradients of K4) runs
on the tensor cores as 3xTF32: each fp32 operand splits into hi = tf32(x)
and lo = tf32(x - hi), and each product sums lo·hi + hi·lo + hi·hi in fp32
(``mm_tf32`` of ``test_torch_attention_numerics.py`` emulates the rounding
bit for bit; a bf16 operand's lo is zero there as on the card). These tests
run the plain versions ``ln_attn_bwd_plain`` and ``ln_mlp_bwd_plain`` with
those products emulated, at the text tower's widths (D = 512, 8 heads,
hidden 2048) and a CoOp step's rows (100 prompts of 24 tokens, so each
weight gradient sums over K = T = 2,400 rows), and hold every gradient to
the card's backward tolerance of the plain version (``BWD_RTOL`` of
chip_smoke.py: 1e-4 x (max|plain| + |plain|), one bf16 ulp of that for a
bf16 gradient): 3xTF32 stays within it, one TF32 pass does not. They also
pin the tile and split-K plan of ``_gemm_bwd_plan`` at those shapes.
"""

import numpy as np
import pytest
import torch

from clip_gp_tpu_torch.ops import flash_attention as fa
from test_torch_attention_numerics import mm_tf32

BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
B, N, D, HEADS, HIDDEN = 100, 24, 512, 8, 2048


def _args(block, dtype):
    rng = np.random.default_rng(7 if block == "k3" else 8)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    x = rnd(B, N, D).to(dtype)
    ln = (1 + 0.1 * rnd(D), 0.1 * rnd(D))
    dout = rnd(B, N, D).to(dtype)
    if block == "k3":
        mask = torch.triu(torch.full((N, N), float("-inf")), 1)
        return (x, *ln, rnd(D, 3 * D, scale=D**-0.5).to(dtype),
                (0.1 * rnd(3 * D)).to(dtype), rnd(D, D, scale=D**-0.5).to(dtype),
                mask, HEADS, dout)
    return (x, *ln, rnd(D, HIDDEN, scale=D**-0.5).to(dtype), 0.1 * rnd(HIDDEN),
            rnd(HIDDEN, D, scale=HIDDEN**-0.5).to(dtype), dout)


def _worst(got, ref):
    """The largest error of any gradient over its allowance: at most 1
    within the tolerance."""
    worst = 0.0
    for out, expected in zip(got, ref):
        limit = BWD_RTOL[out.dtype] * (expected.float().abs().max()
                                       + expected.float().abs())
        worst = max(worst, ((out.float() - expected.float()).abs() / limit).max().item())
    return worst


def _run(block, dtype):
    plain = fa.ln_attn_bwd_plain if block == "k3" else fa.ln_mlp_bwd_plain
    args = _args(block, dtype)
    ref = plain(*args)
    return ref, lambda passes: plain(*args, mm=lambda a, b: mm_tf32(a, b, passes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", ["k3", "k4"])
def test_3xtf32_products_hold_the_backward_tolerance(block, dtype):
    ref, emulated = _run(block, dtype)
    assert _worst(emulated(3), ref) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", ["k3", "k4"])
def test_one_tf32_pass_misses_the_backward_tolerance(block, dtype):
    ref, emulated = _run(block, dtype)
    assert _worst(emulated(1), ref) > 1.0


@pytest.mark.parametrize("t", [B * N, 256 * N], ids=["coop-B100", "cocoop-B256"])
def test_weight_gradients_split_k_to_fill_the_card(t):
    """dWqkv, dWout, dWfc and dWproj: 128x128 tiles, K split so that about
    two blocks an SM of 132 run, each split at least 256 rows."""
    for m, n in ((D, 3 * D), (D, D), (D, HIDDEN), (HIDDEN, D)):
        tile, splits = fa._gemm_bwd_plan(m, n, t, "tn", 132)
        tiles = -(-m // 128) * -(-n // 128)
        assert tile == fa._TILE_128
        assert 2 <= splits and tiles * splits <= 2 * 132 and t // splits >= 256


@pytest.mark.parametrize(
    "t, n, tile",
    [(2400, D, fa._TILE_64), (6144, D, fa._TILE_128X64),
     (2400, 3 * D, fa._TILE_64), (6144, 3 * D, fa._TILE_128X64),
     (2400, HIDDEN, fa._TILE_128X64), (6144, HIDDEN, fa._TILE_128)],
    ids=["T2400-N512", "T6144-N512", "T2400-N1536", "T6144-N1536", "T2400-N2048",
         "T6144-N2048"],
)
def test_dx_products_take_smaller_tiles_where_large_ones_leave_sms_idle(t, n, tile):
    """The plan at the dx products' shapes, as the tile timings of
    chip_smoke.py on an H100 ranked the three shapes."""
    for product in ("nn_bias", "nt", "nt_gelu_bwd"):
        assert fa._gemm_bwd_plan(t, n, D, product, 132) == (tile, 1)
