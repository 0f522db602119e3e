"""The arithmetic of K3's attention-core backward on the card
(``clip_gp_tpu_torch/csrc/attention_bwd.cu``), emulated on the CPU.

The kernel runs all six products of the core (S = q_s·kᵀ, O = P·v, dP =
d_out·vᵀ, dv = Pᵀ·d_out, dq = dS·k/8, dk = dSᵀ·q_s) on the tensor cores as
3xTF32: each fp32 operand splits into hi = tf32(x) and lo = tf32(x - hi),
and each 8-deep k-step sums lo·hi + hi·lo + hi·hi apart, then adds that
sum to the fp32 accumulator. The k of S and dP is the head width (64); of O
and dq the keys, of dv and dk the queries (N, 24 or 77 here). The GEMMs
around it (gemm_bwd.cu) run the same scheme. ``mm_ksteps`` emulates it:
the operands' rounding bit for bit (``split_tf32`` of
``test_torch_attention_numerics.py``), each k-step's sum and its addition
in fp32 rounding to nearest. These tests run ``ln_attn_bwd_plain`` with
every product so emulated at the text tower's widths (D = 512, 8 heads,
causal or a random finite mask, a few prompts of 24 and of 77 tokens) and
hold all seven gradients to the card's backward tolerance (``BWD_RTOL`` of
chip_smoke.py: 1e-4 x (max|ref| + |ref|)) against the plain version and
against ``_ln_attn_bwd_kernel`` in interpret mode, and to the JAX suite's
gradient tolerance (rtol 1e-4, atol 1e-5) against the latter with each
gradient divided by its largest value: that tolerance is meant for
gradients of order one, and at these widths, where the weight gradients
reach tens, even the plain fp32 version, summing in another order, misses
an unscaled atol of 1e-5 (tested below). One TF32 pass in the six
attention products (the GEMMs left at 3xTF32) misses the card's tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_gp_tpu.ops import flash_attention as jfa
from clip_gp_tpu_torch.ops import flash_attention as tfa
from test_torch_attention_numerics import split_tf32

BWD_RTOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, D, HEADS = 3, 512, 8
NAMES = ("dx", "dln_scale", "dln_bias", "dw_qkv", "db_qkv", "dw_out", "db_out")


def mm_ksteps(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b with TF32 operands (3xTF32, or hi·hi alone), each 8-deep k-step
    summed apart and added to an fp32 accumulator in k order."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    acc = None
    for k0 in range(0, a.shape[-1], 8):
        ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
        part = ah[ka] @ bh[kb]
        if passes == 3:
            part = (al[ka] @ bh[kb] + ah[ka] @ bl[kb]) + part
        acc = part if acc is None else acc + part
    return acc


@functools.lru_cache(maxsize=None)
def _inputs(n, mask_kind):
    rng = np.random.default_rng(n + (0 if mask_kind == "causal" else 1))

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    mask = (np.triu(np.full((n, n), -np.inf, np.float32), 1) if mask_kind == "causal"
            else 2 * f(n, n))
    return (f(B, n, D), 1 + 0.1 * f(D), 0.1 * f(D), f(D, 3 * D, scale=D**-0.5),
            0.1 * f(3 * D), f(D, D, scale=D**-0.5), mask, f(B, n, D))


def _plain(n, mask_kind, attn_passes=None):
    """ln_attn_bwd_plain on the inputs: fp32 products (None), or every
    product emulated, the six attention products with ``attn_passes``."""
    x, g, b, wq, bq, wo, mask, dout = (torch.from_numpy(a) for a in _inputs(n, mask_kind))
    if attn_passes is None:
        return tfa.ln_attn_bwd_plain(x, g, b, wq, bq, wo, mask, HEADS, dout)
    return tfa.ln_attn_bwd_plain(
        x, g, b, wq, bq, wo, mask, HEADS, dout, mm=mm_ksteps,
        attn_mm=lambda p, q: mm_ksteps(p, q, attn_passes))


def _worst(got, ref):
    """The largest error of any gradient over its allowance: at most 1
    within the tolerance."""
    worst = 0.0
    for out, expected in zip(got, ref):
        limit = BWD_RTOL * (expected.abs().max() + expected.abs())
        worst = max(worst, ((out - expected).abs() / limit).max().item())
    return worst


CASES = [(24, "causal"), (77, "causal"), (24, "random"), (77, "random")]
IDS = [f"N{n}-{kind}" for n, kind in CASES]


def test_kstep_emulation_with_one_step_is_the_3xtf32_product():
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((5, 8), (8, 7)))
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    assert torch.equal(mm_ksteps(a, b), (al @ bh + ah @ bl) + ah @ bh)
    assert torch.equal(mm_ksteps(a, b, 1), ah @ bh)


@pytest.mark.parametrize("n, mask_kind", CASES, ids=IDS)
def test_3xtf32_attention_backward_holds_the_card_tolerance(n, mask_kind):
    assert _worst(_plain(n, mask_kind, 3), _plain(n, mask_kind)) <= 1.0


@functools.lru_cache(maxsize=None)
def _pallas(n, mask_kind):
    """The seven gradients of the Pallas kernel in interpret mode."""
    x, g, b, wq, bq, wo, mask, dout = (jnp.asarray(a) for a in _inputs(n, mask_kind))
    return tuple(torch.from_numpy(np.asarray(e)) for e in jfa._ln_attn_bwd_pallas(
        x, g, b, wq, bq, wo, mask, HEADS, dout, interpret=True))


@pytest.mark.parametrize("n, mask_kind", CASES[:2], ids=IDS[:2])
def test_3xtf32_attention_backward_matches_the_pallas_kernel(n, mask_kind):
    for name, got, e in zip(NAMES, _plain(n, mask_kind, 3), _pallas(n, mask_kind)):
        assert _worst([got], [e]) <= 1.0, name
        scale = e.abs().max()
        torch.testing.assert_close(got / scale, e / scale, msg=name, **GRAD_TOL)


def test_the_fp32_plain_version_misses_an_unscaled_atol_at_text_widths():
    """Why the comparison above scales each gradient to order one: the fp32
    plain version itself, against the Pallas kernel, misses rtol 1e-4 / atol
    1e-5 on the raw weight gradients at N=77."""
    def within(got, e):
        return bool(((got - e).abs() <= GRAD_TOL["atol"]
                     + GRAD_TOL["rtol"] * e.abs()).all())

    pairs = list(zip(_plain(77, "causal"), _pallas(77, "causal")))
    assert not all(within(got, e) for got, e in pairs)
    assert all(within(got / e.abs().max(), e / e.abs().max()) for got, e in pairs)


@pytest.mark.parametrize("n, mask_kind", CASES[:2], ids=IDS[:2])
def test_one_tf32_pass_in_the_attention_products_misses_the_tolerance(n, mask_kind):
    assert _worst(_plain(n, mask_kind, 1), _plain(n, mask_kind)) > 1.0
