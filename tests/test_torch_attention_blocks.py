"""Port K7 (``flash_attention``) and K8 (``fused_attention_block``) of
clip_gp_tpu_torch.ops.flash_attention against the JAX functions, whose
Pallas kernels run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version, so these
tests hold the plain versions (the on-card reference of the CUDA kernels) to
the Pallas kernels' numerics: K7 at the shapes of tests/test_flash_attention.py
(a ViT-like N=197, a causal N=77 with eight heads, heads of 32, and N=100,
which the JAX wrapper pads to 128), K8 at a ViT-like ragged N=197 and a
causal N=77 with several heads, and K8's gradients against ``jax.grad``.

Tolerances: fp32 2e-5, as tests/test_flash_attention.py. bf16: both sides
round to bf16 at the same points but sum in different orders, so a value
near a rounding boundary can round the other way: one bf16 ulp, at most
2^-7 of the value, plus 2^-6 absolute near zero. Gradients: rtol 1e-4 /
atol 1e-5, as the JAX test of the custom VJP.
"""

import jax
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
K7_SHAPES = {  # (batch, heads, tokens, head width, causal)
    "vit16": (2, 2, 197, 64, False),
    "text-causal": (1, 8, 77, 64, True),
    "vit32-small-head": (2, 1, 50, 32, False),
    "padding": (1, 1, 100, 64, False),
}
K8_SHAPES = {  # (batch, tokens, width, heads, causal)
    "vit-ragged": (2, 197, 256, 4, False),
    "text-causal": (2, 77, 256, 4, True),
}


def _rng_f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _causal(n, fill=-np.inf):
    return np.triu(np.full((n, n), fill, np.float32), 1)


def _close(port, jax_out, tol):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(jax_out.astype(jnp.float32)),
        **tol,
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(K7_SHAPES))
def test_flash_attention_matches_pallas(shape, dtype):
    b, h, n, dh, causal = K7_SHAPES[shape]
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (_rng_f32(rng, b, h, n, dh) for _ in range(3))
    mask = _causal(n) if causal else None
    expected = jfa.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        None if mask is None else jnp.asarray(mask), interpret=True,
    )
    got = tfa.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == tdt and got.shape == (b, h, n, dh)
    _close(got, expected, tol)


def _block_inputs(b, n, d, causal, seed=0, scale=None, fill=-np.inf):
    rng = np.random.default_rng(seed)
    w = d**-0.5 if scale is None else scale
    p = {
        "h": _rng_f32(rng, b, n, d),
        "w_qkv": _rng_f32(rng, d, 3 * d, scale=w),
        "b_qkv": _rng_f32(rng, 3 * d, scale=scale or 0.1),
        "w_out": _rng_f32(rng, d, d, scale=w),
        "b_out": _rng_f32(rng, d, scale=scale or 0.1),
    }
    p["mask"] = _causal(n, fill) if causal else None
    return p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(K8_SHAPES))
def test_fused_attention_block_matches_pallas(shape, dtype):
    b, n, d, heads, causal = K8_SHAPES[shape]
    jdt, tdt, tol = DTYPES[dtype]
    p = _block_inputs(b, n, d, causal)
    # h and the weights in the working type, the biases in fp32 (both
    # wrappers cast them to the working type)
    expected = jfa.fused_attention_block(
        jnp.asarray(p["h"]).astype(jdt), jnp.asarray(p["w_qkv"]).astype(jdt),
        jnp.asarray(p["b_qkv"]), jnp.asarray(p["w_out"]).astype(jdt),
        jnp.asarray(p["b_out"]), heads,
        None if p["mask"] is None else jnp.asarray(p["mask"]), interpret=True,
    )
    got = tfa.fused_attention_block(
        torch.from_numpy(p["h"]).to(tdt), torch.from_numpy(p["w_qkv"]).to(tdt),
        torch.from_numpy(p["b_qkv"]), torch.from_numpy(p["w_out"]).to(tdt),
        torch.from_numpy(p["b_out"]), heads,
        None if p["mask"] is None else torch.from_numpy(p["mask"]),
    )
    assert got.dtype == tdt and got.shape == (b, n, d)
    _close(got, expected, tol)


def test_fused_attention_block_grads_match_jax_grad():
    """The inputs of tests/test_flash_attention.py's custom-VJP test (batch
    2, 10 tokens, 4 heads, weights ×0.05, a −1e9 causal mask) at head width
    64, the width K8 takes: the port's Function (plain forward on the CPU,
    the eager math's VJP backward) against ``jax.grad`` of the JAX
    ``fused_attention_block``, every differentiable input."""
    b, n, d, heads = 2, 10, 256, 4
    p = _block_inputs(b, n, d, True, scale=0.05, fill=-1e9)
    names = ("h", "w_qkv", "b_qkv", "w_out", "b_out")
    jmask = jnp.asarray(p["mask"])

    def loss(args):
        out = jfa.fused_attention_block(*args, heads, jmask, interpret=True)
        return jnp.sum(out**2)

    expected = jax.grad(loss)(tuple(jnp.asarray(p[k]) for k in names))
    args = [torch.from_numpy(p[k]).requires_grad_(True) for k in names]
    out = tfa.fused_attention_block(*args, heads, torch.from_numpy(p["mask"]))
    (out**2).sum().backward()
    for name, arg, exp in zip(names, args, expected):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(exp),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _qkv(b=1, h=2, n=9, dh=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(b, h, n, dh, generator=g).to(dtype) for _ in range(3)]


def test_flash_attention_refuses_a_tracked_input():
    """The Pallas kernel has no JVP, so ``jax.grad`` through it fails; the
    port's wrapper refuses an input that needs a gradient, and runs under
    ``torch.no_grad()``."""
    q, k, v = _qkv()
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize(
    "change, error, match",
    [
        (dict(dh=48), ValueError, "32 or 64"),
        (dict(n=257), ValueError, "N <= 256"),
        (dict(dtype=torch.float16), TypeError, "float32 or bfloat16"),
    ],
    ids=["head-width", "too-many-tokens", "dtype"],
)
def test_flash_attention_refuses_what_the_kernel_does_not_take(change, error,
                                                                match):
    with pytest.raises(error, match=match):
        tfa.flash_attention(*_qkv(**change))


def test_flash_attention_refuses_mixed_dtypes():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="v must be"):
        tfa.flash_attention(q, k, v.to(torch.bfloat16))


def _k8_args(dtype=torch.float32, b=1, n=9, d=128, heads=2):
    p = _block_inputs(b, n, d, False)
    return [torch.from_numpy(p[k]).to(dtype)
            for k in ("h", "w_qkv", "b_qkv", "w_out", "b_out")] + [heads]


def test_fused_attention_block_refuses_weights_of_another_dtype():
    """The Pallas kernel would multiply a bf16 h by fp32 weights in fp32, the
    eager math would cast them to bf16: the port takes neither reading and
    refuses the call."""
    args = _k8_args(dtype=torch.bfloat16)
    args[1] = args[1].float()
    with pytest.raises(ValueError, match="w_qkv must be a contiguous 2-D "
                                         "torch.bfloat16"):
        tfa.fused_attention_block(*args)


def test_fused_attention_block_refuses_a_mask_that_needs_a_gradient():
    args = _k8_args()
    mask = torch.zeros(9, 9, requires_grad=True)
    with pytest.raises(RuntimeError, match="mask"):
        tfa.fused_attention_block(*args, mask)
    with pytest.raises(ValueError, match="head width"):
        tfa.fused_attention_block(*_k8_args(d=96))


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    tfa.reset_launch_counts()
    q, k, v = _qkv()
    torch.testing.assert_close(tfa.flash_attention(q, k, v),
                               tfa.attention_plain(q, k, v), rtol=0, atol=0)
    args = _k8_args()
    torch.testing.assert_close(tfa.fused_attention_block(*args),
                               tfa.attention_block_plain(*args), rtol=0, atol=0)
    assert not any(tfa.LAUNCHES.values())
