"""The arithmetic of the attention core's CUDA kernel
(``clip_gp_tpu_torch/csrc/attention.cu``), emulated on the CPU.

In fp32 the core runs both products on the tensor cores as 3xTF32: each
operand splits into hi = tf32(x) and lo = tf32(x - hi), where tf32 is PTX's
``cvt.rna.tf32.f32`` (round to 10 stored mantissa bits, ties away from
zero), and each product sums lo·hi + hi·lo + hi·hi in fp32. These tests
emulate that rounding bit for bit and show why the core takes three passes:
attention with 3xTF32 products stays within the card's fp32 tolerance of
``attention_plain`` (atol = rtol = 1e-4, as in ``chip_smoke.py``), and one
pass of TF32 does not. They also hold the core's division by the row sum
(Markstein's sequence: q = x·r, then q + (x - q·s)·r by FMAs, with r the
correctly rounded reciprocal) to IEEE division.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from clip_gp_tpu_torch.ops import flash_attention as fa

FP32_TOL = dict(atol=1e-4, rtol=1e-4)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of fp32 values: the low 13 of the 23 mantissa
    bits cleared, rounding to nearest with ties away from zero (adding half
    of the dropped range to the magnitude's bits carries into the kept ones)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and fp32 sums: hi·hi alone, or 3xTF32.
    Products of two TF32 values are exact in fp32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def attention_tf32(q, k, v, mask, passes: int) -> torch.Tensor:
    """The fp32 core's math with both products on emulated tensor cores."""
    q = q * torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=torch.float32)
    scores = mm_tf32(q, k.transpose(-1, -2), passes)
    if mask is not None:
        scores = scores + mask
    scores = scores - scores.amax(-1, keepdim=True)
    weights = scores.exp()
    return mm_tf32(weights / weights.sum(-1, keepdim=True), v, passes)


@pytest.mark.parametrize(
    "x, expected",
    [
        (1 + 2.0**-11, 1 + 2.0**-10),  # a tie: away from zero (even would give 1)
        (-(1 + 2.0**-11), -(1 + 2.0**-10)),
        (1 + 2.0**-12, 1.0),  # under half an ulp: down
        (1 + 3 * 2.0**-12, 1 + 2.0**-10),  # over half: up
        (2 - 2.0**-12, 2.0),  # the carry reaches the exponent
        (0.0, 0.0),
    ],
    ids=["tie", "negative-tie", "down", "up", "carry", "zero"],
)
def test_tf32_rounds_to_nearest_with_ties_away_from_zero(x, expected):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == expected


def test_tf32_split_keeps_ten_mantissa_bits_and_loses_under_2_to_the_minus_22():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=100_000)
                          * 10.0 ** rng.uniform(-6, 6, size=100_000)).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())


@pytest.mark.parametrize("scale", [1.0, 3.0], ids=["scale1", "scale3"])
@pytest.mark.parametrize("n, causal", [(77, True), (197, False)],
                         ids=["text-N77-causal", "vit-N197"])
@pytest.mark.parametrize("dh", [32, 64], ids=["Dh32", "Dh64"])
def test_3xtf32_holds_the_fp32_tolerance_and_one_pass_does_not(dh, n, causal, scale):
    rng = np.random.default_rng(dh + n)
    q, k, v = (torch.from_numpy((scale * rng.normal(size=(2, 8, n, dh)))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.triu(torch.full((n, n), float("-inf")), 1) if causal else None
    ref = fa.attention_plain(q, k, v, mask)
    torch.testing.assert_close(attention_tf32(q, k, v, mask, 3), ref, **FP32_TOL)
    assert not torch.allclose(attention_tf32(q, k, v, mask, 1), ref, **FP32_TOL)


def _round_f32(r: Fraction) -> np.float32:
    """The fp32 nearest to the exact value r, ties to even."""
    c = np.float32(float(r))
    near = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - r),
                                    int(y.view(np.int32)) & 1))


def _fma(a, b, c) -> np.float32:
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_the_row_sum_division_sequence_is_ieee_division():
    """The softmax's e / sum, for e in (0, 1] and sum in [1, 256] as the
    core's rows give them, from exp(0) down to exp(-80)."""
    rng = np.random.default_rng(1)
    sums = rng.uniform(1, 256, size=3000).astype(np.float32)
    xs = np.exp(-rng.uniform(0, 80, size=3000)).astype(np.float32)
    xs[:200] = np.minimum(sums[:200], 1).astype(np.float32)
    for x, s in zip(xs, sums):
        r = np.float32(1) / s
        q = x * r
        got = _fma(_fma(-q, s, x), r, q)
        assert got == x / s, (x, s, got, x / s)
