"""The port's int8 serving ops (``ops/int8_block.py``, ``models/quantized.py``)
against the JAX package's, on the CPU.

Inputs are made with numpy and go through both. The JAX int8 Pallas kernels
run in interpret mode, as ``tests/test_quantized.py`` runs them.

- ``quantize_rows``, ``quantize_weight`` and ``quantize_visual`` are the same
  fp32 ops on both sides and must agree bit for bit, ties and all-zero rows
  included.
- The plain K5/K6 follow the Pallas kernels' rounding points; their products
  are exact int32 on both sides, so they differ only where an fp32 sum taken
  in another order (the LayerNorm statistics, the softmax, p·v) moves one
  activation across a quantization boundary. Allowed: at least 99.9% of the
  elements within the K1/K2 tolerance of the dtype (fp32 1e-4 + 1e-4·|ref|,
  bf16 2^-6 + 2^-7·|ref|, one bf16 ulp), and a mean |Δ| of at most 1e-3 of
  the mean |ref|.
- The int8 TEST-ViT tower must give each image the JAX tower's features
  (cosine ≥ 0.9999, fused and unfused) and stay close to the fp32 tower
  (cosine > 0.99, the JAX suite's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_gp_tpu.models import clip_model as jcm
from clip_gp_tpu.models import quantized as jq
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz
from clip_gp_tpu.ops import int8_block as jib
from clip_gp_tpu_torch.models import clip_loader as tcl
from clip_gp_tpu_torch.models import quantized as tq
from clip_gp_tpu_torch.ops import int8_block as tib

TOL = {"fp32": (1e-4, 1e-4), "bf16": (2.0**-6, 2.0**-7)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_mostly_close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    atol, rtol = TOL[dtype]
    inside = np.abs(got - ref) <= atol + rtol * np.abs(ref)
    assert inside.mean() >= 0.999, (inside.mean(), np.abs(got - ref).max())
    assert np.abs(got - ref).mean() <= 1e-3 * np.abs(ref).mean()


def _rows():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(6, 40)).astype(np.float32)
    rows[1] *= 1e-3
    rows[2] = 0.0
    ties = np.zeros(40, np.float32)
    ties[:5] = [127.0, 2.5, -2.5, 3.5, -3.5]  # absmax 127: scale 1, exact ties
    rows[3] = ties
    rows[4, :3] = [0.5, -0.5, 1.5]
    rows[4, 3] = -(np.abs(rows[4]).max() * 2)
    return rows


def test_quantize_rows_matches_jax_bit_for_bit():
    rows = _rows()
    jq_, js = jib.quantize_rows(jnp.asarray(rows))
    q, s = tib.quantize_rows(torch.from_numpy(rows))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the ties round half to even, the zero row keeps the 1e-12 floor
    np.testing.assert_array_equal(q[3, :5].numpy(), [127, 2, -2, 4, -4])
    assert s[2, 0].item() == np.float32(1e-12) and not q[2].any()


def test_quantize_rows_kernel_wrapper_runs_the_plain_version_on_the_cpu():
    rows = torch.from_numpy(_rows())
    for got, expected in zip(tib.quantize_rows_kernel(rows), tib.quantize_rows(rows)):
        assert torch.equal(got, expected)


def test_quantize_weight_matches_jax_bit_for_bit():
    w = np.random.default_rng(1).normal(size=(3, 16, 8)).astype(np.float32)
    expected = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].shape == (3, 8)
    for key in ("q", "scale"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(expected[key]))


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    arch = jcm.ARCHITECTURES["TEST-ViT"]
    params = init_clip_params(jax.random.key(0), arch)
    path = str(tmp_path_factory.mktemp("weights") / "test_vit.npz")
    save_params_npz(path, arch, params)
    t_arch, model = tcl.load_params_npz(path, device="cpu")
    return {"arch": arch, "params": params, "t_arch": t_arch, "model": model,
            "jq": jq.quantize_visual(params, arch),
            "tq": tq.quantize_visual(model, t_arch)}


def test_quantize_visual_matches_jax_bit_for_bit(tower):
    blocks = tower["jq"]["transformer"]["blocks"]
    leaves = {
        "attn/w_qkv": lambda p: p["attn"]["w_qkv"],
        "attn/w_out": lambda p: p["attn"]["w_out"],
        "mlp/c_fc/w": lambda p: p["mlp"]["c_fc"]["w"],
        "mlp/c_proj/w": lambda p: p["mlp"]["c_proj"]["w"],
    }
    assert len(tower["tq"]["blocks"]) == tower["arch"].vision_layers
    for i, block in enumerate(tower["tq"]["blocks"]):
        for name, leaf in leaves.items():
            for key in ("q", "scale"):
                np.testing.assert_array_equal(
                    leaf(block)[key].numpy(), np.asarray(leaf(blocks)[key][i]),
                    err_msg=f"layer {i} {name} {key}")
        np.testing.assert_array_equal(block["attn"]["b_qkv"].numpy(),
                                      np.asarray(blocks["attn"]["b_qkv"][i]))
    assert tower["tq"]["visual"] is tower["model"].visual


def test_quantize_visual_rejects_resnet():
    with pytest.raises(NotImplementedError, match="ViT"):
        tq.quantize_visual(None, tcl.ARCHITECTURES["TEST-RN"])


def _block_inputs(rng, b, n, d, dtype):
    hidden = 4 * d

    def w(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = {"x": rng.normal(size=(b, n, d)).astype(np.float32),
         "ln_scale": 1 + w(d, scale=0.1), "ln_bias": w(d, scale=0.1),
         "b_qkv": w(3 * d), "b_out": w(d), "b_fc": w(hidden), "b_pr": w(d)}
    for name, shape in (("wqkv", (d, 3 * d)), ("wout", (d, d)),
                        ("wfc", (d, hidden)), ("wpr", (hidden, d))):
        qw = jq.quantize_weight(jnp.asarray(w(*shape, scale=d**-0.5)))
        p[name + "_q"], p[name + "_scale"] = np.asarray(qw["q"]), np.asarray(qw["scale"])
    jx = jnp.asarray(p["x"]).astype(JDT[dtype])
    return p, jx, _t(jx.astype(jnp.float32)).to(TDT[dtype])


def _causal(n):
    return np.triu(np.full((n, n), -np.inf, np.float32), 1)


K5_CASES = [(n, dtype, masked) for n in (9, 17) for dtype in ("fp32", "bf16")
            for masked in (False, True)]


@pytest.mark.parametrize("n,dtype,masked", K5_CASES,
                         ids=[f"N{n}-{dt}-{'causal' if m else 'nomask'}"
                              for n, dt, m in K5_CASES])
def test_k5_plain_matches_pallas_interpret(n, dtype, masked):
    rng = np.random.default_rng(n + 2 * masked)
    p, jx, x = _block_inputs(rng, 2, n, 128, dtype)
    mask = _causal(n) if masked else None
    args = ("ln_scale", "ln_bias", "wqkv_q", "wqkv_scale", "b_qkv", "wout_q",
            "wout_scale", "b_out")
    expected = jib.q8_ln_attention_block(
        jx, *(jnp.asarray(p[a]) for a in args), 2,
        mask=None if mask is None else jnp.asarray(mask), interpret=True)
    got = tib.q8_ln_attention_block(
        x, *(_t(p[a]) for a in args), 2, None if mask is None else _t(mask))
    assert got.dtype == TDT[dtype] and got.shape == x.shape
    _assert_mostly_close(got, expected, dtype)


@pytest.mark.parametrize("n", [9, 17])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k6_plain_matches_pallas_interpret(n, dtype):
    rng = np.random.default_rng(100 + n)
    p, jx, x = _block_inputs(rng, 2, n, 128, dtype)
    args = ("ln_scale", "ln_bias", "wfc_q", "wfc_scale", "b_fc", "wpr_q",
            "wpr_scale", "b_pr")
    expected = jib.q8_ln_mlp(jx, *(jnp.asarray(p[a]) for a in args),
                             interpret=True)
    got = tib.q8_ln_mlp(x, *(_t(p[a]) for a in args))
    assert got.dtype == TDT[dtype] and got.shape == x.shape
    _assert_mostly_close(got, expected, dtype)


def test_int8_matmul_is_exact_at_the_mlp_depth():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, size=(4, 3072), dtype=np.int8)
    b = rng.integers(-127, 128, size=(3072, 5), dtype=np.int8)
    got = tib.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_q8_wrappers_refuse_a_tracked_input():
    rng = np.random.default_rng(4)
    p, _, x = _block_inputs(rng, 1, 5, 128, "fp32")
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        tib.q8_ln_mlp(x, *(_t(p[a]) for a in ("ln_scale", "ln_bias", "wfc_q",
                                             "wfc_scale", "b_fc", "wpr_q",
                                             "wpr_scale", "b_pr")))
    scale = _t(p["ln_scale"]).requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        tib.q8_ln_attention_block(
            x.detach(), scale, *(_t(p[a]) for a in (
                "ln_bias", "wqkv_q", "wqkv_scale", "b_qkv", "wout_q",
                "wout_scale", "b_out")), 2)
    with torch.no_grad():  # the same call outside autograd runs
        tib.q8_ln_attention_block(
            x, scale, *(_t(p[a]) for a in (
                "ln_bias", "wqkv_q", "wqkv_scale", "b_qkv", "wout_q",
                "wout_scale", "b_out")), 2)


def test_cpu_calls_count_no_launch():
    rng = np.random.default_rng(5)
    p, _, x = _block_inputs(rng, 1, 3, 128, "fp32")
    tib.reset_launch_counts()
    tib.q8_ln_mlp(x, *(_t(p[a]) for a in ("ln_scale", "ln_bias", "wfc_q",
                                         "wfc_scale", "b_fc", "wpr_q",
                                         "wpr_scale", "b_pr")))
    assert tib.LAUNCHES == {"q8_ln_attention_block": 0, "q8_ln_mlp": 0}


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_encode_image_q8_matches_jax(tower, fused):
    rng = np.random.default_rng(9)
    images = rng.uniform(-1.5, 1.5, size=(3, 32, 32, 3)).astype(np.float32)
    expected = jq.encode_image_q8(tower["jq"], tower["arch"], jnp.asarray(images),
                                  use_fused=fused)
    got = tq.encode_image_q8(tower["tq"], tower["t_arch"], torch.from_numpy(images),
                             use_fused=fused)
    assert got.dtype == torch.float32 and got.shape == (3, tower["arch"].embed_dim)
    cos = _cosine(got.numpy(), expected)
    assert (cos >= 0.9999).all(), cos
    with torch.no_grad():
        fp32 = tower["model"].encode_image(torch.from_numpy(images))
    cos = _cosine(got.numpy(), fp32.numpy())
    assert (cos > 0.99).all(), cos
