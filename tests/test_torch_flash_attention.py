"""Port K1/K2 (clip_gp_tpu_torch.ops.flash_attention) against the JAX Pallas
kernels, which run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version, so these
tests hold the plain versions (the on-card reference of the CUDA kernels) to
the Pallas kernels' numerics, with several heads, a ViT-like ragged N=197
without mask and a causal N=77.

Tolerances: fp32 2e-5, as tests/test_flash_attention.py. bf16: both sides
round to bf16 (8 significant bits) at the same points but sum in different
orders, so a value near a rounding boundary can round the other way: one
bf16 ulp, at most 2^-7 of the value, plus 2^-6 absolute near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_gp_tpu.ops import flash_attention as jfa
from clip_gp_tpu_torch.ops import flash_attention as tfa

DTYPES = {
    "fp32": (jnp.float32, torch.float32, dict(rtol=0, atol=2e-5)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2.0**-7, atol=2.0**-6)),
}
SHAPES = {
    "vit-ragged": (2, 197, 256, 4, False),
    "text-causal": (2, 77, 256, 4, True),
}


def _inputs(b, n, d, causal, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = {
        "x": f(b, n, d),
        "ln_scale": 1 + 0.1 * f(d), "ln_bias": 0.1 * f(d),
        "w_qkv": f(d, 3 * d, scale=d**-0.5), "b_qkv": 0.1 * f(3 * d),
        "w_out": f(d, d, scale=d**-0.5), "b_out": 0.1 * f(d),
        "w_fc": f(d, 4 * d, scale=d**-0.5), "b_fc": 0.1 * f(4 * d),
        "w_proj": f(4 * d, d, scale=(4 * d) ** -0.5), "b_proj": 0.1 * f(d),
    }
    p["mask"] = np.triu(np.full((n, n), -np.inf, np.float32), 1) if causal else None
    return p


def _j(a, dt=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dt)


def _t(a, dt=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dt)


def _close(port, jax_out, tol):
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(jax_out.astype(jnp.float32)), **tol
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ln_attention_block_matches_pallas(shape, dtype):
    b, n, d, heads, causal = SHAPES[shape]
    jdt, tdt, tol = DTYPES[dtype]
    p = _inputs(b, n, d, causal)
    # weights and biases in the working type, as clip_model's block passes them
    expected = jfa.fused_ln_attention_block(
        _j(p["x"], jdt), _j(p["ln_scale"]), _j(p["ln_bias"]),
        _j(p["w_qkv"], jdt), _j(p["b_qkv"], jdt), _j(p["w_out"], jdt),
        _j(p["b_out"], jdt), heads, _j(p["mask"]), interpret=True,
    )
    got = tfa.fused_ln_attention_block(
        _t(p["x"], tdt), _t(p["ln_scale"]), _t(p["ln_bias"]),
        _t(p["w_qkv"], tdt), _t(p["b_qkv"], tdt), _t(p["w_out"], tdt),
        _t(p["b_out"], tdt), heads, _t(p["mask"]),
    )
    assert got.dtype == tdt and got.shape == (b, n, d)
    _close(got, expected, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ln_mlp_matches_pallas(shape, dtype):
    b, n, d, _, _ = SHAPES[shape]
    jdt, tdt, tol = DTYPES[dtype]
    p = _inputs(b, n, d, False, seed=1)
    # fp32 weights and biases, as clip_model passes them (the kernel casts)
    expected = jfa.fused_ln_mlp(
        _j(p["x"], jdt), _j(p["ln_scale"]), _j(p["ln_bias"]), _j(p["w_fc"]),
        _j(p["b_fc"]), _j(p["w_proj"]), _j(p["b_proj"]), interpret=True,
    )
    got = tfa.fused_ln_mlp(
        _t(p["x"], tdt), _t(p["ln_scale"]), _t(p["ln_bias"]),
        _t(p["w_fc"], tdt), _t(p["b_fc"]), _t(p["w_proj"], tdt),
        _t(p["b_proj"]),
    )
    assert got.dtype == tdt and got.shape == (b, n, d)
    _close(got, expected, tol)


def _k1_args(dtype=torch.float32, b=1, n=9, d=128, heads=2):
    p = _inputs(b, n, d, False)
    return [
        _t(p["x"], dtype), _t(p["ln_scale"]), _t(p["ln_bias"]),
        _t(p["w_qkv"], dtype), _t(p["b_qkv"], dtype), _t(p["w_out"], dtype),
        _t(p["b_out"], dtype), heads,
    ]


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tfa.reset_launch_counts()
    args = _k1_args()
    out = tfa.fused_ln_attention_block(*args)
    torch.testing.assert_close(out, tfa.ln_attention_block_plain(*args),
                               rtol=0, atol=0)
    p = _inputs(1, 9, 128, False)
    tfa.fused_ln_mlp(_t(p["x"]), _t(p["ln_scale"]), _t(p["ln_bias"]),
                     _t(p["w_fc"]), _t(p["b_fc"]), _t(p["w_proj"]),
                     _t(p["b_proj"]))
    assert set(tfa.LAUNCHES) == {"fused_ln_attention_block", "fused_ln_mlp",
                                 "ln_attn_bwd", "ln_mlp_bwd"}
    assert not any(tfa.LAUNCHES.values())


def test_wrapper_rejects_unsupported_dtype():
    args = _k1_args()
    args[0] = args[0].to(torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.fused_ln_attention_block(*args)


def test_wrapper_rejects_mismatched_weight_dtype():
    args = _k1_args(dtype=torch.bfloat16)
    args[3] = args[3].float()
    with pytest.raises(ValueError, match="w_qkv"):
        tfa.fused_ln_attention_block(*args)


def test_wrapper_rejects_grad_requiring_input():
    """Every input but the mask is differentiable (K3 gives their
    gradients); a mask that needs a gradient is refused."""
    args = _k1_args()
    args[3].requires_grad_(True)
    tfa.fused_ln_attention_block(*args).sum().backward()
    assert args[3].grad is not None
    mask = torch.zeros(9, 9, requires_grad=True)
    with pytest.raises(RuntimeError, match="mask"):
        tfa.fused_ln_attention_block(*args, mask)
    with torch.no_grad():  # no autograd: the mask is a constant
        tfa.fused_ln_attention_block(*args, mask)


@pytest.mark.parametrize("index", [1, 4, 6], ids=["ln_scale", "b_qkv", "b_out"])
def test_wrapper_rejects_a_vector_of_the_wrong_length(index):
    """The kernels read D (or 3D) values from each vector: a shorter one
    would be read out of bounds, so the wrapper refuses it."""
    args = _k1_args()
    args[index] = args[index][:-1]
    with pytest.raises(ValueError, match="of shape"):
        tfa.fused_ln_attention_block(*args)


def test_mlp_wrapper_rejects_a_bias_of_the_wrong_length():
    p = _inputs(1, 9, 128, False)
    with pytest.raises(ValueError, match="b_fc"):
        tfa.fused_ln_mlp(_t(p["x"]), _t(p["ln_scale"]), _t(p["ln_bias"]),
                         _t(p["w_fc"]), _t(p["b_fc"][:-8]), _t(p["w_proj"]),
                         _t(p["b_proj"]))


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(d=96, heads=2), "head width"),  # head width 48
        (dict(n=257), "N <= 256"),
    ],
    ids=["head-width", "too-many-tokens"],
)
def test_wrapper_rejects_shapes_the_kernel_does_not_take(change, match):
    with pytest.raises(ValueError, match=match):
        tfa.fused_ln_attention_block(*_k1_args(**change))
