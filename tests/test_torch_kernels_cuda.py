"""The hand-written CUDA kernels K1-K4 against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA GPU and nvcc and
skips without them. The file imports neither jax nor the JAX package, so it
runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Shapes cover the ragged edges the kernels mask themselves: token counts
that are not multiples of the 64-row query tile or the 128-row GEMM tile, a
single token, the 256-token limit, a causal mask, and an MLP width that is
not a multiple of the 128-column tile. Tolerances are chip_smoke.py's: fp32
1e-4, since both sides sum the same fp32 products in other orders; bf16 one
bf16 ulp (2^-7 relative plus 2^-6 absolute), since both round to bf16 at the
same points and another summation order can flip one rounding. The backward
kernels K3/K4 sum up to T = B·N rows of products into each weight gradient,
so their absolute tolerance scales with the gradient's largest value: 1e-4
of it (fp32) or one bf16 ulp of it (a gradient that comes out in bf16).
"""

import pytest
import torch

from clip_gp_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2.0**-6, rtol=2.0**-7)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from clip_gp_tpu_torch.core.device import resolve_device

    return resolve_device("cuda")


def _inputs(b, n, d, dtype, device, causal=False, hidden=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    hidden = hidden or 4 * d

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    p = {
        "x": rnd(b, n, d).to(dtype),
        "ln_scale": 1 + 0.1 * rnd(d), "ln_bias": 0.1 * rnd(d),
        "w_qkv": rnd(d, 3 * d, scale=d**-0.5).to(dtype),
        "b_qkv": (0.1 * rnd(3 * d)).to(dtype),
        "w_out": rnd(d, d, scale=d**-0.5).to(dtype),
        "b_out": (0.1 * rnd(d)).to(dtype),
        "w_fc": rnd(d, hidden, scale=d**-0.5).to(dtype), "b_fc": 0.1 * rnd(hidden),
        "w_proj": rnd(hidden, d, scale=hidden**-0.5).to(dtype),
        "b_proj": 0.1 * rnd(d),
    }
    p["mask"] = (torch.triu(torch.full((n, n), float("-inf"), device=device), 1)
                 if causal else None)
    return p


def _k1(p, heads, fn=fa.fused_ln_attention_block):
    return fn(p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
              p["w_out"], p["b_out"], heads, p["mask"])


def _k2(p, fn=fa.fused_ln_mlp):
    return fn(p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"],
              p["w_proj"], p["b_proj"])


def _assert_close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


DTYPES = [torch.float32, torch.bfloat16]
K1_SHAPES = [  # (batch, tokens, width, heads, causal)
    (3, 1, 128, 2, False),
    (2, 65, 128, 2, True),
    (2, 197, 768, 12, False),
    (3, 77, 512, 8, True),
    (1, 256, 256, 4, False),
]
K2_SHAPES = [  # (batch, tokens, width, hidden)
    (3, 1, 128, 512),
    (2, 197, 768, 3072),
    (3, 77, 512, 2048),
    (2, 33, 200, 808),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K1_SHAPES, ids=str)
def test_k1_kernel_matches_plain(device, shape, dtype):
    b, n, d, heads, causal = shape
    p = _inputs(b, n, d, dtype, device, causal=causal)
    with torch.no_grad():
        _assert_close(_k1(p, heads), _k1(p, heads, fa.ln_attention_block_plain),
                      dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K2_SHAPES, ids=str)
def test_k2_kernel_matches_plain(device, shape, dtype):
    b, n, d, hidden = shape
    p = _inputs(b, n, d, dtype, device, hidden=hidden)
    with torch.no_grad():
        _assert_close(_k2(p), _k2(p, fa.ln_mlp_plain), dtype)


def _assert_grad_close(out, ref, name):
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape, name
    assert bool(torch.isfinite(out).all()), name
    scale = ref.float().abs().max().item()
    rtol = 2.0**-7 if out.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=rtol * scale, msg=name)


K3_SHAPES = [  # (batch, tokens, width, heads, causal)
    (3, 1, 128, 2, True),
    (3, 11, 128, 2, True),
    (100, 24, 512, 8, True),
    (2, 77, 512, 8, True),
    (2, 197, 768, 12, False),
    (1, 256, 256, 4, False),
]
K4_SHAPES = [  # (batch, tokens, width, hidden)
    (3, 1, 128, 512),
    (3, 11, 128, 512),
    (100, 24, 512, 2048),
    (2, 33, 200, 808),
]
GRADS = [True, False]


def _dout(p, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(p["x"].shape, generator=g).to(p["x"].device, p["x"].dtype)


@pytest.mark.parametrize("param_grads", GRADS, ids=["all", "dx-only"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_k3_kernel_matches_plain(device, shape, dtype, param_grads):
    b, n, d, heads, causal = shape
    p = _inputs(b, n, d, dtype, device, causal=causal)
    args = (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
            p["w_out"], p["mask"], heads, _dout(p))
    got = fa.ln_attn_bwd(*args, param_grads=param_grads)
    ref = fa.ln_attn_bwd_plain(*args)
    for i, (out, expected) in enumerate(zip(got, ref)):
        if param_grads or i == 0:
            _assert_grad_close(out, expected, i)
        else:
            assert out is None


@pytest.mark.parametrize("param_grads", GRADS, ids=["all", "dx-only"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=str)
def test_k4_kernel_matches_plain(device, shape, dtype, param_grads):
    b, n, d, hidden = shape
    p = _inputs(b, n, d, dtype, device, hidden=hidden)
    args = (p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"],
            p["w_proj"], _dout(p))
    got = fa.ln_mlp_bwd(*args, param_grads=param_grads)
    ref = fa.ln_mlp_bwd_plain(*args)
    for i, (out, expected) in enumerate(zip(got, ref)):
        if param_grads or i == 0:
            _assert_grad_close(out, expected, i)
        else:
            assert out is None


def test_backward_kernels_repeat_bit_for_bit(device):
    """No atomics: the cross-row sums take a fixed order."""
    p = _inputs(100, 24, 512, torch.float32, device, causal=True)
    args = (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
            p["w_out"], p["mask"], 8, _dout(p))
    first, second = fa.ln_attn_bwd(*args), fa.ln_attn_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_each_call_on_the_card_counts_one_launch(device):
    p = _inputs(2, 9, 128, torch.float32, device)
    fa.reset_launch_counts()
    with torch.no_grad():
        _k1(p, 2)
        _k1(p, 2)
        _k2(p)
    p["x"].requires_grad_(True)
    _k2(p).sum().backward()
    assert fa.LAUNCHES == {"fused_ln_attention_block": 2, "fused_ln_mlp": 2,
                           "ln_attn_bwd": 0, "ln_mlp_bwd": 1}


def test_grad_requiring_input_on_the_card_runs_the_backward_kernels(device):
    p = _inputs(4, 24, 128, torch.float32, device, causal=True)
    p["x"].requires_grad_(True)
    fa.reset_launch_counts()
    out = _k2({**p, "x": _k1(p, 2)})
    dout = _dout(p)
    (got,) = torch.autograd.grad(out, p["x"], dout)
    x = p["x"].detach()
    h = fa.ln_attention_block_plain(x, p["ln_scale"], p["ln_bias"], p["w_qkv"],
                                    p["b_qkv"], p["w_out"], p["b_out"], 2, p["mask"])
    dh = fa.ln_mlp_bwd_plain(h, p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"],
                             p["w_proj"], dout)[0]
    expected = fa.ln_attn_bwd_plain(x, p["ln_scale"], p["ln_bias"], p["w_qkv"],
                                    p["b_qkv"], p["w_out"], p["mask"], 2, dh)[0]
    _assert_grad_close(got, expected, "dx")
    assert fa.LAUNCHES["ln_attn_bwd"] == fa.LAUNCHES["ln_mlp_bwd"] == 1


def test_grad_requiring_mask_on_the_card_raises(device):
    p = _inputs(1, 9, 128, torch.float32, device, causal=True)
    p["mask"] = torch.zeros(9, 9, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="mask"):
        _k1(p, 2)


def test_tower_through_the_kernels_matches_the_plain_tower(device):
    from unittest import mock

    from clip_gp_tpu_torch.models import clip_model
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params

    model = init_clip_params(clip_model.ARCHITECTURES["TEST-ViT"], seed=0,
                             device=device)
    images = torch.randn(5, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    images = images.to(device)
    tokens = torch.zeros(4, 77, dtype=torch.long, device=device)
    tokens[:, 0], tokens[:, 1:6] = 49406, 320
    tokens[torch.arange(4), torch.tensor([6, 7, 8, 9])] = 49407
    with torch.no_grad():
        got = model.encode_image(images), model.encode_text(tokens)
        with mock.patch.object(clip_model, "fused_ln_attention_block",
                               fa.ln_attention_block_plain), \
                mock.patch.object(clip_model, "fused_ln_mlp", fa.ln_mlp_plain):
            ref = model.encode_image(images), model.encode_text(tokens)
    for out, expected in zip(got, ref):
        _assert_close(out, expected, torch.float32)
