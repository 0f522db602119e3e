"""The arithmetic of the fp32 forward blocks K1, K2 and K8 on the card,
emulated on the CPU.

In fp32 every matrix product of these blocks runs on the tensor cores as
3xTF32: the four GEMMs of ``ln_gemm.cu`` (qkv, out-projection, c_fc,
c_proj) on the core of ``gemm_tf32.cuh``, and q·kᵀ and p·v in the attention
core of ``attention.cu``. Each fp32 operand splits into hi = tf32(x) and lo
= tf32(x - hi), and each product sums lo·hi + hi·lo + hi·hi in fp32
(``mm_tf32`` of ``test_torch_attention_numerics.py`` emulates the rounding
of the operands bit for bit and sums in fp32 rounding to nearest, as the
GEMM core adds each 8-deep k-step's sum to its accumulators; the sums that
the tensor cores chain themselves keep fewer bits, which this emulation does
not model, and which is why the core does not chain its accumulators through
them). These tests run the plain versions ``ln_attention_block_plain``,
``ln_mlp_plain`` and ``attention_block_plain`` with every product so
emulated, at ViT-B/16's widths (D = 768, 12 heads, hidden 3,072, so the
GEMMs sum over K = 768 and 3,072) and 197 tokens, and hold them to the
card's fp32 tolerance against the plain versions in fp32 (chip_smoke.py's
``TOLERANCES["fp32"]``: |Δ| <= 1e-4 + 1e-4·|plain| elementwise): 3xTF32
stays within it, one TF32 pass does not. They also pin the tile shape that
``_tile_plan`` picks for each forward product at the paths' shapes on a card
of 132 SMs.
"""

import numpy as np
import pytest
import torch

from clip_gp_tpu_torch.ops import flash_attention as fa
from test_torch_attention_numerics import mm_tf32

FP32_ATOL, FP32_RTOL = 1e-4, 1e-4
B, N, D, HEADS, HIDDEN = 2, 197, 768, 12, 3072


def _args(block):
    """The block's positional arguments at ViT-B/16 widths, as chip_smoke.py
    draws them (unit activations, weights scaled by 1/√fan-in)."""
    rng = np.random.default_rng({"k1": 11, "k2": 12, "k8": 13}[block])

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    x = rnd(B, N, D)
    if block == "k2":
        return (x, 1 + 0.1 * rnd(D), 0.1 * rnd(D), rnd(D, HIDDEN, scale=D**-0.5),
                0.1 * rnd(HIDDEN), rnd(HIDDEN, D, scale=HIDDEN**-0.5), 0.1 * rnd(D))
    attn = (rnd(D, 3 * D, scale=D**-0.5), 0.1 * rnd(3 * D), rnd(D, D, scale=D**-0.5),
            0.1 * rnd(D), HEADS, None)
    if block == "k8":
        return (x, *attn)
    return (x, 1 + 0.1 * rnd(D), 0.1 * rnd(D), *attn)


PLAIN = {"k1": fa.ln_attention_block_plain, "k2": fa.ln_mlp_plain,
         "k8": fa.attention_block_plain}


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "1xtf32"])
@pytest.mark.parametrize("block", ["k1", "k2", "k8"])
def test_3xtf32_holds_the_forward_tolerance_and_one_pass_does_not(block, passes):
    args = _args(block)
    ref = PLAIN[block](*args)
    got = PLAIN[block](*args, mm=lambda a, b: mm_tf32(a, b, passes))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # the largest error over its allowance: at most 1 within the tolerance
    worst = ((got - ref).abs() / (FP32_ATOL + FP32_RTOL * ref.abs())).max().item()
    if passes == 3:
        assert worst <= 1.0
    else:
        assert worst > 1.0


# (rows M, the products' (name, N), expected tile) at ViT-B/16 B=32 and
# B=512 (197 tokens, D = 768) and the text tower's template encode (B=256,
# 77 tokens, D = 512)
FWD_PLAN = [
    (32 * 197, 768, {"qkv": fa._TILE_128, "out_proj": fa._TILE_64,
                     "c_fc": fa._TILE_128, "c_proj": fa._TILE_64}),
    (512 * 197, 768, {"qkv": fa._TILE_128, "out_proj": fa._TILE_128,
                      "c_fc": fa._TILE_128, "c_proj": fa._TILE_128}),
    (256 * 77, 512, {"qkv": fa._TILE_128, "out_proj": fa._TILE_128,
                     "c_fc": fa._TILE_128, "c_proj": fa._TILE_128}),
]


@pytest.mark.parametrize("m, d, tiles", FWD_PLAN, ids=["vit-B32", "vit-B512", "text-B256"])
def test_forward_products_take_the_planned_tile(m, d, tiles):
    """The tile shape of each fp32 forward product, by the rule that picks
    the dx products' shapes (one planner for both GEMMs)."""
    widths = {"qkv": 3 * d, "out_proj": d, "c_fc": 4 * d, "c_proj": d}
    for product, n in widths.items():
        assert fa._tile_plan(m, n, 132) == tiles[product], product
        assert fa._gemm_bwd_plan(m, n, d, "nt", 132) == (tiles[product], 1)
