"""The plain version of the int8 GEMM core (``ops/int8_block.py``
``q8_gemm_plain``) and the weights' K-major copies the core reads, on the
CPU.

The card tests hold ``csrc/int8_block.cu``'s product bit for bit against
``q8_gemm_plain``; these tests show that ``q8_gemm_plain`` is, bit for bit,
each of the four products that the plain K5 and K6 compute (which
``tests/test_torch_int8_block.py`` holds against the Pallas kernels), so the
card's bit-for-bit checks reach the JAX package's arithmetic. The core reads
W as [N, K]: ``quantize_visual`` keeps that copy ("qt") beside each weight,
and the wrappers check the shape of a copy they are given.
"""

import numpy as np
import pytest
import torch

from clip_gp_tpu_torch.ops import int8_block as ib
from clip_gp_tpu_torch.ops.flash_attention import layer_norm_f32

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _operands(m, n, k, groups, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    row_scale = torch.from_numpy(
        (rng.random((m, groups)) * 1e-2 + 1e-4).astype(np.float32))
    col_scale = torch.from_numpy((rng.random(n) * 1e-2 + 1e-4).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=n) * 0.1).astype(np.float32))
    return a, w, row_scale, col_scale, bias


@pytest.mark.parametrize("dtype", DTYPES)
def test_q8_gemm_plain_composes_the_plain_k6_bit_for_bit(dtype):
    b, n, d, hidden = 2, 9, 64, 256
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(
        DTYPES[dtype])
    ln_scale = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32))
    ln_bias = torch.from_numpy((0.1 * rng.normal(size=d)).astype(np.float32))
    _, wfc, _, sfc, bfc = _operands(1, hidden, d, 1, seed=2)
    _, wpr, _, spr, bpr = _operands(1, d, hidden, 1, seed=3)
    ref = ib.q8_ln_mlp_plain(x, ln_scale, ln_bias, wfc, sfc, bfc, wpr, spr, bpr)

    x2d = x.reshape(-1, d)
    hq, hs = ib.quantize_rows(layer_norm_f32(x2d.float(), ln_scale, ln_bias))
    hid = ib.q8_gemm_plain(hq, wfc, hs, sfc, bfc, "gelu", torch.float32)
    gq, gs = ib.quantize_rows(hid)
    got = ib.q8_gemm_plain(gq, wpr, gs, spr, bpr, "resid_mlp", x.dtype, resid=x2d)
    assert torch.equal(got.view(b, n, d), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_q8_gemm_plain_is_the_plain_k5_qkv_and_grouped_out_projection(dtype):
    t, d, heads = 13, 128, 2
    dh = d // heads
    dt = DTYPES[dtype]
    hq, wqkv, hs, sqkv, bqkv = _operands(t, 3 * d, d, 1, seed=4)
    # K5's qkv: (acc·hs·s_qkv + b_qkv) rounded to the working type
    ref = (ib.int8_matmul(hq, wqkv).float() * hs * sqkv + bqkv).to(dt)
    assert torch.equal(ib.q8_gemm_plain(hq, wqkv, hs, sqkv, bqkv, "qkv", dt), ref)
    # K5's out-projection: the heads' parts summed from zero in head order
    oq, wout, os, sout, bout = _operands(t, d, d, heads, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(t, d)).astype(
        np.float32)).to(dt)
    acc = torch.zeros(t, d)
    for h in range(heads):
        part = ib.int8_matmul(oq[:, h * dh:(h + 1) * dh], wout[h * dh:(h + 1) * dh])
        acc = acc + part.float() * os[:, h:h + 1] * sout
    ref = ((x.float() + acc) + bout).to(dt)
    got = ib.q8_gemm_plain(oq, wout, os, sout, bout, "resid_attn", dt,
                           group_k=dh, resid=x)
    assert torch.equal(got, ref)


def test_q8_gemm_plain_scales_int32_sums_past_2_to_the_24():
    # a row of 127s against a column of 127s at K = 3072: 127²·3072 > 2²⁴,
    # where fp32 is no longer exact; the int32 sum is, and it is rounded to
    # fp32 once, before the scales
    k = 3072
    a = torch.full((2, k), 127, dtype=torch.int8)
    a[1] = -127
    w = torch.full((k, 3), 127, dtype=torch.int8)
    one = torch.ones(3)
    got = ib.q8_gemm_plain(a, w, torch.ones(2, 1), one, torch.zeros(3), "qkv",
                           torch.float32)
    exact = 127 * 127 * k
    assert exact > 2**24
    assert got[0].tolist() == [float(np.float32(exact))] * 3
    assert got[1].tolist() == [-float(np.float32(exact))] * 3


def test_quantize_visual_keeps_a_k_major_copy_of_each_weight():
    from clip_gp_tpu_torch.models import clip_model, quantized
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params

    arch = clip_model.ARCHITECTURES["TEST-ViT"]
    qvisual = quantized.quantize_visual(
        init_clip_params(arch, seed=0, device="cpu"), arch)
    for block in qvisual["blocks"]:
        for wq in (block["attn"]["w_qkv"], block["attn"]["w_out"],
                   block["mlp"]["c_fc"]["w"], block["mlp"]["c_proj"]["w"]):
            assert wq["qt"].is_contiguous() and wq["qt"].dtype == torch.int8
            assert torch.equal(wq["qt"], wq["q"].t())


def test_q8_wrappers_refuse_a_k_major_copy_of_the_wrong_shape():
    d, hidden = 64, 256
    x = torch.zeros(1, 3, d)
    ones = torch.ones(d)
    _, wfc, _, sfc, bfc = _operands(1, hidden, d, 1, seed=7)
    _, wpr, _, spr, bpr = _operands(1, d, hidden, 1, seed=8)
    args = (x, ones, ones, wfc, sfc, bfc, wpr, spr, bpr)
    ref = ib.q8_ln_mlp(*args)
    assert torch.equal(ib.q8_ln_mlp(*args, wfc.t().contiguous(),
                                    wpr.t().contiguous()), ref)
    with pytest.raises(ValueError, match="wfc_qt"):
        ib.q8_ln_mlp(*args, wfc, wpr.t().contiguous())
