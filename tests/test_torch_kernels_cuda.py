"""The hand-written CUDA kernels K1-K8 against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA GPU and nvcc and
skips without them. The file imports neither jax nor the JAX package, so it
runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Shapes cover the ragged edges the kernels mask themselves: token counts
at and beside the attention core's 16-row query strips and 16-key chunks,
token counts that are not multiples of the 128-row GEMM tile, a single
token, the 256-token limit and past it (the key-tiled core), a causal and a
random finite additive mask, and
an MLP width that is not a multiple of the 128-column tile. Tolerances are chip_smoke.py's: fp32
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
    (2, 17, 128, 2, True),
    (1, 256, 128, 2, True),
    (400, 24, 512, 8, True),  # a trial-batched CoOp step, T x K = 4 x 100
]
K2_SHAPES = [  # (batch, tokens, width, hidden)
    (3, 1, 128, 512),
    (2, 197, 768, 3072),
    (3, 77, 512, 2048),
    (2, 33, 200, 808),
    (400, 24, 512, 2048),
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


# ---------------------------------------------------------------------------
# The GEMM of ln_gemm.cu that K1, K2 and K8 launch, called directly with
# each of its five epilogues (after the LN pass for qkv and c_fc), against
# the plain composition of the same roundings, at the ragged edges of its
# output and k tiles: one row, a row short of and past a 128-row tile,
# ViT-B/16 at 32 images (6,304 rows); N = 800 and 200 (not multiples of
# 128 or 64) and K = 200 (not a multiple of 32 or 16): c_fc and c_proj at
# D = 200. bf16 runs its own kernel (128x128 tiles, 64-deep k-tiles); fp32
# the 3xTF32 core of gemm_tf32.cuh with each of its three tile shapes.
# ---------------------------------------------------------------------------

GEMM_EPILOGUES = list(fa.GEMM_EPILOGUES)
GEMM_ROWS = [1, 127, 129, 6304]
GEMM_KN = [(200, 800), (800, 200)]
GEMM_TILES = {"128": fa._TILE_128, "128x64": fa._TILE_128X64, "64": fa._TILE_64}


def _gemm_inputs(m, k, n, device, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    return {"a": rnd(m, k).to(dtype), "w": rnd(k, n, scale=k**-0.5).to(dtype),
            "bias": 0.1 * rnd(n), "resid": rnd(m, n).to(dtype),
            "gamma": 1 + 0.1 * rnd(k), "beta": 0.1 * rnd(k)}


def _gemm_kernel(p, epilogue, tile=None):
    """One launch of ln_gemm.cu's product with ``epilogue`` (after the LN
    pass for qkv and c_fc); ``tile`` forces an fp32 tile shape."""
    from clip_gp_tpu_torch.ops import _build

    code = GEMM_EPILOGUES.index(epilogue)
    lib = _build.library()
    a = p["a"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    out = torch.empty(a.shape[0], p["w"].shape[1], dtype=a.dtype, device=a.device)
    if epilogue in ("qkv", "gelu"):
        a = fa._ln_input(lib, a, p["gamma"], p["beta"], stream)
    resid = epilogue.startswith("resid")
    fa._gemm(lib, a, p["w"], p["bias"], out, code, stream,
             resid=p["resid"] if resid else None, tile=tile)
    return out


def _gemm_plain(p, epilogue):
    ln = epilogue in ("qkv", "gelu")
    return fa.gemm_plain(p["a"], p["w"], p["bias"], epilogue, resid=p["resid"],
                         ln_scale=p["gamma"] if ln else None,
                         ln_bias=p["beta"] if ln else None)


@pytest.mark.parametrize("kn", GEMM_KN, ids=lambda kn: f"K{kn[0]}-N{kn[1]}")
@pytest.mark.parametrize("m", GEMM_ROWS, ids=lambda m: f"M{m}")
@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
def test_bf16_gemm_epilogue_matches_plain(device, epilogue, m, kn):
    p = _gemm_inputs(m, *kn, device, seed=m)
    _assert_close(_gemm_kernel(p, epilogue), _gemm_plain(p, epilogue),
                  torch.bfloat16)


def test_bf16_gemm_repeats_bit_for_bit(device):
    """No split-K, no atomics: each output element is summed by one thread in
    a fixed k order."""
    p = _gemm_inputs(6304, 768, 2304, device, seed=5)
    for epilogue in GEMM_EPILOGUES:
        assert torch.equal(_gemm_kernel(p, epilogue), _gemm_kernel(p, epilogue))


@pytest.mark.parametrize("tile", list(GEMM_TILES), ids=lambda t: f"tile{t}")
@pytest.mark.parametrize("kn", GEMM_KN, ids=lambda kn: f"K{kn[0]}-N{kn[1]}")
@pytest.mark.parametrize("m", GEMM_ROWS, ids=lambda m: f"M{m}")
@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
def test_fp32_gemm_epilogue_matches_plain(device, epilogue, m, kn, tile):
    p = _gemm_inputs(m, *kn, device, seed=m, dtype=torch.float32)
    _assert_close(_gemm_kernel(p, epilogue, GEMM_TILES[tile]),
                  _gemm_plain(p, epilogue), torch.float32)


def test_fp32_gemm_repeats_bit_for_bit(device):
    """The 3xTF32 core splits no K and has no atomics: with each tile shape
    two calls agree bit for bit."""
    p = _gemm_inputs(6304, 768, 2304, device, seed=6, dtype=torch.float32)
    for epilogue in GEMM_EPILOGUES:
        for tile in GEMM_TILES.values():
            assert torch.equal(_gemm_kernel(p, epilogue, tile),
                               _gemm_kernel(p, epilogue, tile))


def test_fp32_gemm_refuses_a_shape_outside_its_layout(device):
    """N and K must be multiples of 4 in fp32: the C entry refuses, and the
    wrapper raises, with no other route."""
    from clip_gp_tpu_torch.ops import _build

    p = _gemm_inputs(64, 202, 64, device, dtype=torch.float32)
    out = torch.empty(64, 64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with pytest.raises(RuntimeError, match="ln_gemm"):
        fa._gemm(_build.library(), p["a"], p["w"], p["bias"], out,
                 GEMM_EPILOGUES.index("bias"), stream)


def _assert_grad_close(out, ref, name):
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape, name
    assert bool(torch.isfinite(out).all()), name
    scale = ref.float().abs().max().item()
    rtol = 2.0**-7 if out.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=rtol * scale, msg=name)


K3_SHAPES = [  # (batch, tokens, width, heads, mask: True causal, "random")
    (3, 1, 128, 2, True),
    (3, 11, 128, 2, True),
    (100, 24, 512, 8, True),
    (2, 77, 512, 8, True),
    (2, 197, 768, 12, False),
    (1, 256, 256, 4, False),
    # the attention backward's edges: its buckets of 8-key tiles (3, 4 and
    # 10 in one launch; past 80 tokens the split launches, 32) and 16-row
    # strips
    (2, 1, 128, 2, "random"),
    (2, 15, 128, 2, True),
    (2, 16, 128, 2, "random"),
    (2, 17, 128, 2, False),
    (4, 24, 128, 2, "random"),
    (2, 33, 128, 2, True),
    (2, 77, 128, 2, "random"),
    (2, 80, 128, 2, True),
    (2, 81, 128, 2, "random"),
    (2, 128, 128, 2, True),
    (2, 129, 128, 2, "random"),
    (1, 256, 128, 2, True),
    (1, 256, 128, 2, "random"),
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
    b, n, d, heads, mask = shape
    p = _inputs(b, n, d, dtype, device, causal=mask is True)
    if mask == "random":  # a finite additive mask
        g = torch.Generator().manual_seed(n)
        p["mask"] = (2 * torch.randn(n, n, generator=g)).to(device)
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
    """No atomics: the cross-row sums take a fixed order, in K3 and K4."""
    p = _inputs(100, 24, 512, torch.float32, device, causal=True)
    args = (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
            p["w_out"], p["mask"], 8, _dout(p))
    first, second = fa.ln_attn_bwd(*args), fa.ln_attn_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    args = (p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"],
            p["w_proj"], _dout(p))
    first, second = fa.ln_mlp_bwd(*args), fa.ln_mlp_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_backward_repeats_bit_for_bit_past_128_tokens(device):
    """K3 at 197 tokens, past the 80 where the attention backward's two
    sides run as two launches with the row statistics between them."""
    p = _inputs(2, 197, 256, torch.float32, device)
    args = (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
            p["w_out"], p["mask"], 4, _dout(p))
    first, second = fa.ln_attn_bwd(*args), fa.ln_attn_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The 3xTF32 GEMM core of gemm_bwd.cu that K3 and K4 launch, each of their
# six products called directly (after the pass that writes its A: LN(x), or
# QuickGELU(hid_pre), here from PyTorch) with each tile shape, against
# gemm_bwd_plain, at the ragged edges of its 128x128, 128x64 and 64x64 tiles
# and 16-deep k-tiles: M one row, a row short of and past a tile, the text
# tower at 100 prompts; N 200 and 808 (not multiples of 64); K 24
# and 520 (not multiples of 16), and 6,144 rows, which a weight gradient
# splits. For the "tn" products M is the contiguous dimension of A [K, M],
# so M = 1, 127 and 129 take the 4-byte copies. fp32 tolerance of the
# backward kernels: 1e-4 x (max|plain| + |plain|).
# ---------------------------------------------------------------------------

GEMM_BWD_OPS = list(fa.GEMM_BWD_OPS)
GEMM_BWD_ROWS = [1, 127, 129, 2400]
GEMM_BWD_NK = [(n, k) for n in (200, 808, 1536) for k in (24, 520, 6144)]
GEMM_BWD_TILES = {"128": fa._TILE_128, "128x64": fa._TILE_128X64, "64": fa._TILE_64}


def _gemm_bwd_inputs(op, m, n, k, dtype, device, seed=0):
    """The operands of ``op`` at out [m, n], sum over k; x / dout (the io
    operand) in ``dtype``."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    p = {"bias": 0.1 * rnd(n), "aux": rnd(m, n)}
    if op == "ln_nn_bias":
        p["a"], p["b"] = rnd(m, k), rnd(k, n, scale=k**-0.5)
    elif op in ("nt", "nt_gelu_bwd"):
        p["a"], p["b"] = rnd(m, k), rnd(n, k, scale=k**-0.5)
    else:
        p["a"], p["b"] = rnd(k, m), rnd(k, n, scale=k**-0.5)
    io = "b" if op in ("tn", "gelu_tn") else "a"
    p[io] = p[io].to(dtype)
    width = p["a"].shape[1]
    p["ln_scale"], p["ln_bias"] = 1 + 0.1 * rnd(width), 0.1 * rnd(width)
    return p


def _gemm_bwd_kernel(p, op, tile=None, splits=None, act=None):
    """One launch of ``op``'s product of gemm_bwd.cu, after the pass that
    writes its A."""
    from clip_gp_tpu_torch.ops import _build

    lib = _build.library()
    a, b = p["a"], p["b"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if op in ("ln_nn_bias", "ln_tn"):
        a = fa._ln_f32(lib, a, p["ln_scale"], p["ln_bias"], stream)[1]
    elif op == "gelu_tn":
        a = fa.quick_gelu(a)
    product = fa.GEMM_BWD_OPS[op]
    if product == "tn":
        (k, m), n = a.shape, b.shape[1]
    else:
        (m, k), n = a.shape, b.shape[1 if product == "nn_bias" else 0]
    plan = None
    if tile is not None:
        sms = fa._sm_count(a.device.index or 0)
        plan = (tile, splits or fa._gemm_bwd_plan(m, n, k, product, sms)[1])
    return fa._gemm_bwd(lib, product, a, b, m, n, k, stream,
                        bias=p["bias"] if product == "nn_bias" else None,
                        aux=p["aux"] if product == "nt_gelu_bwd" else None,
                        act=act, plan=plan)


def _gemm_bwd_plain(p, op):
    return fa.gemm_bwd_plain(op, p["a"], p["b"], bias=p["bias"], aux=p["aux"],
                             ln_scale=p["ln_scale"], ln_bias=p["ln_bias"])


@pytest.mark.parametrize("tile", list(GEMM_BWD_TILES), ids=lambda t: f"tile{t}")
@pytest.mark.parametrize("m", GEMM_BWD_ROWS, ids=lambda m: f"M{m}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", GEMM_BWD_OPS)
def test_gemm_bwd_product_matches_plain(device, op, dtype, m, tile):
    for n, k in GEMM_BWD_NK:
        p = _gemm_bwd_inputs(op, m, n, k, dtype, device, seed=m + n + k)
        act = (torch.empty(m, n, device=device) if op == "ln_nn_bias" else None)
        got = _gemm_bwd_kernel(p, op, GEMM_BWD_TILES[tile], act=act)
        ref = _gemm_bwd_plain(p, op)
        _assert_grad_close(got, ref, f"{op} M={m} N={n} K={k}")
        if act is not None:
            _assert_grad_close(act, fa.quick_gelu(ref), f"{op} act M={m} N={n} K={k}")


def test_gemm_bwd_split_products_repeat_bit_for_bit(device):
    """A weight gradient split over K sums its parts in a fixed order: two
    calls agree bit for bit, and with an unsplit call to the tolerance."""
    for dtype in DTYPES:
        p = _gemm_bwd_inputs("tn", 512, 2048, 6144, dtype, device, seed=7)
        first = _gemm_bwd_kernel(p, "tn", fa._TILE_128, splits=4)
        assert torch.equal(first, _gemm_bwd_kernel(p, "tn", fa._TILE_128, splits=4))
        _assert_grad_close(first, _gemm_bwd_kernel(p, "tn", fa._TILE_128, splits=1),
                           "tn split 4 vs 1")


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
                           "ln_attn_bwd": 0, "ln_mlp_bwd": 1,
                           "flash_attention": 0, "fused_attention_block": 0,
                           "key_tiled_attention": 0}


def test_k1_launches_on_its_tensors_device_from_a_thread_on_another(device):
    """A thread whose current device is cuda:0 launches K1 for tensors on
    cuda:1: the wrapper enters the tensors' device around the launch, so the
    shared-memory opt-in and the launch land there, and the result equals
    the plain version on cuda:1."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    other = torch.device("cuda", 1)
    p = _inputs(3, 77, 512, torch.float32, other)
    out = {}

    def run():
        torch.cuda.set_device(0)
        with torch.no_grad():
            out["k1"] = _k1(p, 8)
        torch.cuda.synchronize(other)

    th = threading.Thread(target=run)
    th.start()
    th.join()
    assert out["k1"].device == other
    with torch.no_grad():
        _assert_close(out["k1"], _k1(p, 8, fa.ln_attention_block_plain),
                      torch.float32)


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


# ---------------------------------------------------------------------------
# K5/K6: the int8 blocks of the serving tower (ops/int8_block.py). Their
# products are exact in int32 on both sides, so the kernels and the plain
# versions differ only where an fp32 sum taken in another order (LayerNorm
# statistics, softmax, p·v) moves one activation across a quantization
# boundary. Such a flip moves the outputs it feeds by one quantization step
# times the weights, up to about 1e-2 at ViT-B/16 width, and in an fp32 block
# it spreads to every query of the image (a flipped LN code changes a key
# and a value): measured on the H100, 96.7% of an fp32 K5's elements at B=32
# lie within the fp32 tolerance and all of them within one bf16 ulp. So
# both working types are held to the bf16 tolerance (2^-6 + 2^-7·|plain|):
# at least 99.9% of the elements within it, and a mean |Δ| of at most 1e-3
# of the mean |plain|.
# ---------------------------------------------------------------------------

def _q8_inputs(b, n, d, dtype, device, causal=False, hidden=None, seed=0):
    from clip_gp_tpu_torch.models.quantized import quantize_weight

    p = _inputs(b, n, d, torch.float32, device, causal=causal, hidden=hidden,
                seed=seed)
    p["x"] = p["x"].to(dtype)
    for key in ("w_qkv", "w_out", "w_fc", "w_proj"):
        p[key] = quantize_weight(p[key])
    return p


def _k5(p, heads, fn=None):
    from clip_gp_tpu_torch.ops import int8_block as ib

    fn = fn or ib.q8_ln_attention_block
    return fn(p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"]["q"],
              p["w_qkv"]["scale"], p["b_qkv"], p["w_out"]["q"],
              p["w_out"]["scale"], p["b_out"], heads, p["mask"])


def _k6(p, fn=None):
    from clip_gp_tpu_torch.ops import int8_block as ib

    fn = fn or ib.q8_ln_mlp
    return fn(p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"]["q"],
              p["w_fc"]["scale"], p["b_fc"], p["w_proj"]["q"],
              p["w_proj"]["scale"], p["b_proj"])


def _assert_mostly_close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    diff = (out.float() - ref.float()).abs()
    tol = TOL[torch.bfloat16]
    inside = (diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).float().mean()
    assert inside.item() >= 0.999, (inside.item(), diff.max().item())
    assert diff.mean().item() <= 1e-3 * ref.float().abs().mean().item()


K5_SHAPES = [  # (batch, tokens, width, heads, causal)
    (2, 9, 128, 2, False),
    (2, 17, 128, 2, True),
    (3, 1, 128, 2, False),
    (3, 197, 768, 12, False),
    (2, 77, 512, 8, True),
    (1, 256, 256, 4, False),
    (1, 256, 128, 2, True),
]
K6_SHAPES = [  # (batch, tokens, width, hidden)
    (2, 9, 128, 512),
    (3, 1, 128, 512),
    (3, 197, 768, 3072),
    (2, 33, 256, 800),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K5_SHAPES, ids=str)
def test_k5_kernel_matches_plain(device, shape, dtype):
    from clip_gp_tpu_torch.ops import int8_block as ib

    b, n, d, heads, causal = shape
    p = _q8_inputs(b, n, d, dtype, device, causal=causal)
    with torch.no_grad():
        _assert_mostly_close(_k5(p, heads),
                             _k5(p, heads, ib.q8_ln_attention_block_plain), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K6_SHAPES, ids=str)
def test_k6_kernel_matches_plain(device, shape, dtype):
    from clip_gp_tpu_torch.ops import int8_block as ib

    b, n, d, hidden = shape
    p = _q8_inputs(b, n, d, dtype, device, hidden=hidden)
    with torch.no_grad():
        _assert_mostly_close(_k6(p), _k6(p, ib.q8_ln_mlp_plain), dtype)


def test_quantize_kernel_matches_quantize_rows_bit_for_bit(device):
    from clip_gp_tpu_torch.ops import int8_block as ib

    g = torch.Generator().manual_seed(3)
    rows = torch.randn(1000, 3072, generator=g) * torch.rand(1000, 1, generator=g) * 8
    rows[1] = 0.0
    rows[2] = 0.0
    rows[2, :5] = torch.tensor([127.0, 2.5, -2.5, 3.5, -3.5])  # scale 1: ties
    rows = rows.to(device)
    q, scale = ib.quantize_rows_kernel(rows)
    ref_q, ref_scale = ib.quantize_rows(rows)
    torch.cuda.synchronize()
    assert torch.equal(q, ref_q) and torch.equal(scale, ref_scale)
    assert q[2, :5].tolist() == [127, 2, -2, 4, -4]


def test_int8_kernels_repeat_bit_for_bit(device):
    p = _q8_inputs(4, 197, 768, torch.bfloat16, device)
    with torch.no_grad():
        assert torch.equal(_k5(p, 12), _k5(p, 12))
        assert torch.equal(_k6(p), _k6(p))


def test_int8_wrappers_never_reach_the_plain_versions_on_the_card(device):
    from unittest import mock

    from clip_gp_tpu_torch.ops import int8_block as ib

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    p = _q8_inputs(2, 9, 128, torch.float32, device)
    ib.reset_launch_counts()
    with torch.no_grad(), \
            mock.patch.object(ib, "q8_ln_attention_block_plain", refuse), \
            mock.patch.object(ib, "q8_ln_mlp_plain", refuse), \
            mock.patch.object(ib, "quantize_rows", refuse):
        _k5(p, 2)
        _k6(p)
    assert ib.LAUNCHES == {"q8_ln_attention_block": 1, "q8_ln_mlp": 1}


def test_int8_wrapper_refuses_a_tracked_input_on_the_card(device):
    p = _q8_inputs(1, 9, 128, torch.float32, device)
    p["x"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference only"):
        _k6(p)


# The int8 GEMM core of csrc/int8_block.cu called directly through the
# wrapper's _q8_gemm (W in the JAX layout [K, N], copied K-major there). Its
# int32 sums are exact and its fp32 epilogue runs q8_gemm_plain's operations
# in q8_gemm_plain's order, so every epilogue but QuickGELU (expf against
# torch.sigmoid: the fp32 tolerance) is held bit for bit. (M, N, K,
# epilogue, group_k): M one row, the ViT-B/16 tokens of 1 and 3 images and
# of the serving batch of 512; N and K past and inside the 128-wide tiles;
# K = 800 and 320 end inside a 128-byte k-tile (320 on a phantom 64-byte
# group of zeros); group_k 160 and 128 take the kernel's run-time grouping,
# 64 with the out-projection's epilogue its compile-time one; a row and a
# column of ±127 make int32 sums past 2^24 at K = 3,072.
Q8_GEMM_CASES = [
    (1, 128, 128, "qkv", None),
    (197, 2304, 768, "qkv", None),
    (591, 800, 800, "qkv", None),
    (100864, 2304, 768, "qkv", None),
    (1, 768, 768, "resid_attn", 64),
    (197, 128, 768, "resid_attn", 64),
    (591, 768, 768, "resid_attn", 64),
    (100864, 768, 768, "resid_attn", 64),
    (591, 800, 800, "resid_attn", 160),
    (591, 256, 320, "resid_attn", 64),
    (197, 800, 768, "qkv", 128),
    (1, 128, 3072, "resid_mlp", None),
    (197, 768, 3072, "resid_mlp", None),
    (591, 800, 800, "resid_mlp", None),
    (100864, 768, 3072, "resid_mlp", None),
    (197, 3072, 768, "gelu", None),
    (591, 800, 128, "gelu", None),
    (100864, 3072, 768, "gelu", None),
]


def _q8_gemm_operands(m, n, k, groups, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-127, 128, (m, k), generator=g, device=device).to(torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=device).to(torch.int8)
    a[0] = 127
    a[-1, : k // 2] = -127
    w[:, 0] = 127
    return {
        "a": a, "w": w,
        "row_scale": torch.rand(m, groups, generator=g, device=device) * 1e-2 + 1e-4,
        "col_scale": torch.rand(n, generator=g, device=device) * 1e-2 + 1e-4,
        "bias": 0.1 * torch.randn(n, generator=g, device=device),
        "resid": torch.randn(m, n, generator=g, device=device).to(dtype),
    }


def _q8_gemm_kernel(p, epilogue, dtype, group_k=None):
    from clip_gp_tpu_torch.ops import _build
    from clip_gp_tpu_torch.ops import int8_block as ib

    a, w = p["a"], p["w"]
    out_dtype = torch.float32 if epilogue == "gelu" else dtype
    out = torch.empty(a.shape[0], w.shape[1], dtype=out_dtype, device=a.device)
    ib._q8_gemm(_build.library(), a, w, p["row_scale"], p["col_scale"], p["bias"],
                out, fa.GEMM_EPILOGUES.index(epilogue),
                torch.cuda.current_stream(a.device).cuda_stream, group_k=group_k,
                resid=p["resid"] if epilogue.startswith("resid") else None)
    return out


# the QuickGELU hidden is fp32 in either working type: fp32 only
@pytest.mark.parametrize("case,dtype", [
    pytest.param(case, dtype, id=f"{case}-{name}")
    for case in Q8_GEMM_CASES
    for dtype, name in zip(DTYPES, ("fp32", "bf16"))
    if case[3] != "gelu" or dtype == torch.float32
])
def test_int8_gemm_matches_plain_bit_for_bit(device, case, dtype):
    from clip_gp_tpu_torch.ops import int8_block as ib

    m, n, k, epilogue, group_k = case
    p = _q8_gemm_operands(m, n, k, k // (group_k or k), dtype, device, seed=m + n + k)
    got = _q8_gemm_kernel(p, epilogue, dtype, group_k)
    ref = ib.q8_gemm_plain(p["a"], p["w"], p["row_scale"], p["col_scale"], p["bias"],
                           epilogue, got.dtype, group_k=group_k, resid=p["resid"])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if epilogue == "gelu":
        _assert_close(got, ref, torch.float32)
    else:
        assert torch.equal(got, ref), (got.float() - ref.float()).abs().max().item()


def test_int8_gemm_repeats_bit_for_bit(device):
    p = _q8_gemm_operands(6304, 3072, 768, 1, torch.bfloat16, device)
    assert torch.equal(_q8_gemm_kernel(p, "gelu", torch.bfloat16),
                       _q8_gemm_kernel(p, "gelu", torch.bfloat16))


def test_int8_gemm_refuses_a_shape_outside_its_layout(device):
    p = _q8_gemm_operands(8, 128, 48, 1, torch.float32, device)
    with pytest.raises(RuntimeError, match="q8_gemm"):
        _q8_gemm_kernel(p, "qkv", torch.float32)


def test_int8_tower_through_the_kernels_matches_the_plain_tower(device):
    from unittest import mock

    from clip_gp_tpu_torch.models import clip_model, quantized
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params
    from clip_gp_tpu_torch.ops import int8_block as ib

    arch = clip_model.ARCHITECTURES["TEST-ViT"]
    model = init_clip_params(arch, seed=0, device=device)
    qvisual = quantized.quantize_visual(model, arch)
    images = torch.randn(6, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    got = quantized.encode_image_q8(qvisual, arch, images.to(device))
    with mock.patch.object(ib, "q8_ln_attention_block", ib.q8_ln_attention_block_plain), \
            mock.patch.object(ib, "q8_ln_mlp", ib.q8_ln_mlp_plain):
        ref = quantized.encode_image_q8(qvisual, arch, images.to(device))
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert bool((cos >= 0.9999).all()), cos


# ---------------------------------------------------------------------------
# K7/K8: standalone attention on [B, H, N, Dh] and the qkv-attention-out block
# without LN or residual (ops/flash_attention.py), held to the forward
# tolerances above.
# ---------------------------------------------------------------------------

K7_SHAPES = [  # (batch, heads, tokens, head width, causal)
    (2, 2, 197, 64, False),
    (1, 8, 77, 64, True),
    (2, 1, 50, 32, False),
    (1, 1, 100, 64, False),
    (3, 2, 1, 32, False),
    (1, 3, 256, 64, True),
    (2, 24, 197, 32, False),
    # the edges of the core's 16-row query strips and 16-key chunks
    (2, 3, 15, 32, False),
    (2, 3, 16, 64, True),
    (2, 3, 17, 32, True),
    (2, 3, 17, 64, False),
    (1, 2, 255, 32, True),
    (1, 2, 255, 64, False),
    (1, 2, 256, 32, False),
    (2, 2, 1, 64, True),
]
K8_SHAPES = [  # (batch, tokens, width, heads, causal)
    (3, 1, 128, 2, False),
    (2, 65, 128, 2, True),
    (2, 197, 768, 12, False),
    (3, 77, 512, 8, True),
    (1, 256, 256, 4, False),
    (2, 17, 128, 2, True),
    (1, 256, 128, 2, True),
]


def _qkv_heads(b, h, n, dh, dtype, device, causal=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, dh, generator=g).to(device, dtype)
               for _ in range(3))
    mask = (torch.triu(torch.full((n, n), float("-inf"), device=device), 1)
            if causal else None)
    return q, k, v, mask


def _k8(p, heads, fn=fa.fused_attention_block):
    return fn(p["x"], p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], heads,
              p["mask"])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K7_SHAPES, ids=str)
def test_k7_kernel_matches_plain(device, shape, dtype):
    b, h, n, dh, causal = shape
    args = _qkv_heads(b, h, n, dh, dtype, device, causal)
    with torch.no_grad():
        _assert_close(fa.flash_attention(*args), fa.attention_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", K8_SHAPES, ids=str)
def test_k8_kernel_matches_plain(device, shape, dtype):
    b, n, d, heads, causal = shape
    p = _inputs(b, n, d, dtype, device, causal=causal)
    with torch.no_grad():
        _assert_close(_k8(p, heads), _k8(p, heads, fa.attention_block_plain),
                      dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n, dh", [(17, 32), (197, 64), (256, 64)], ids=str)
def test_k7_kernel_matches_plain_under_a_random_additive_mask(device, n, dh, dtype):
    q, k, v, _ = _qkv_heads(2, 3, n, dh, dtype, device, seed=n)
    g = torch.Generator().manual_seed(n + 1)
    mask = (2 * torch.randn(n, n, generator=g)).to(device)
    with torch.no_grad():
        _assert_close(fa.flash_attention(q, k, v, mask),
                      fa.attention_plain(q, k, v, mask), dtype)


# ---------------------------------------------------------------------------
# K1's key-tiled attention core past 256 tokens (fp32 only): the core alone
# against attention_plain at the edges of its 64-key and 64-query tiles and
# past ViT-L/14@336px's 577 tokens, with no, a causal and a random finite
# mask; K1 at ViT-L/14@336px's widths (N = 577, D = 1024, 16 heads) against
# the plain block, its repeat bit for bit and its counter.
# ---------------------------------------------------------------------------

def _key_tiled_core(qkv, heads, mask):
    """[B, N, 3D] fp32 -> [B, N, D] through the route of K1 and K8."""
    from clip_gp_tpu_torch.ops import _build

    b, n, three_d = qkv.shape
    d = three_d // 3
    attn = torch.empty(b * n, d, dtype=qkv.dtype, device=qkv.device)
    fa._attention(_build.library(), qkv.view(b * n, three_d), mask, attn, b, n, heads, d,
                  torch.cuda.current_stream(qkv.device).cuda_stream)
    return attn.view(b, n, d)


@pytest.mark.parametrize("mask", ["none", "causal", "random"])
@pytest.mark.parametrize("n", [257, 320, 321, 577, 1000])
def test_key_tiled_core_matches_plain(device, n, mask):
    b, heads, dh = 2, 3, 64
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn(b, n, 3 * heads * dh, generator=g).to(device)
    m = None
    if mask == "causal":
        m = torch.triu(torch.full((n, n), float("-inf"), device=device), 1)
    elif mask == "random":
        m = (2 * torch.randn(n, n, generator=g)).to(device)
    q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2)
               for t in qkv.split(heads * dh, dim=-1))
    fa.reset_launch_counts()
    with torch.no_grad():
        got = _key_tiled_core(qkv, heads, m)
        ref = fa.attention_plain(q, k, v, m).transpose(1, 2).reshape(b, n, heads * dh)
    _assert_close(got, ref, torch.float32)
    assert fa.LAUNCHES["key_tiled_attention"] == 1


@pytest.mark.parametrize("shape", [(4, 577, 1024, 16, False), (2, 300, 128, 2, True)],
                         ids=str)
def test_k1_past_256_tokens_matches_plain_through_the_key_tiled_core(device, shape):
    b, n, d, heads, causal = shape
    p = _inputs(b, n, d, torch.float32, device, causal=causal)
    fa.reset_launch_counts()
    with torch.no_grad():
        out = _k1(p, heads)
        _assert_close(out, _k1(p, heads, fa.ln_attention_block_plain), torch.float32)
        assert torch.equal(out, _k1(p, heads))
    assert fa.LAUNCHES["fused_ln_attention_block"] == fa.LAUNCHES["key_tiled_attention"] == 2


@pytest.mark.parametrize("n", [197, 256])
def test_k1_up_to_256_tokens_keeps_the_strip_kernel(device, n):
    p = _inputs(2, n, 128, torch.float32, device)
    fa.reset_launch_counts()
    with torch.no_grad():
        _k1(p, 2)
    assert fa.LAUNCHES["fused_ln_attention_block"] == 1
    assert fa.LAUNCHES["key_tiled_attention"] == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_attention_core_repeats_bit_for_bit(device, dtype):
    """No atomics: every output element is summed by one thread in a fixed
    order, in K7 and in the core inside K1 and K8."""
    q, k, v, mask = _qkv_heads(3, 12, 197, 64, dtype, device, causal=True)
    p = _inputs(2, 197, 768, dtype, device)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(q, k, v, mask),
                           fa.flash_attention(q, k, v, mask))
        assert torch.equal(_k1(p, 12), _k1(p, 12))
        assert torch.equal(_k8(p, 12), _k8(p, 12))


def test_k7_k8_count_one_launch_a_call_and_never_reach_the_plain_versions(device):
    from unittest import mock

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    qkv = _qkv_heads(2, 2, 9, 32, torch.float32, device)
    p = _inputs(2, 9, 128, torch.float32, device)
    fa.reset_launch_counts()
    with torch.no_grad(), \
            mock.patch.object(fa, "attention_plain", refuse), \
            mock.patch.object(fa, "attention_block_plain", refuse):
        fa.flash_attention(*qkv)
        fa.flash_attention(*qkv)
        _k8(p, 2)
    assert fa.LAUNCHES["flash_attention"] == 2
    assert fa.LAUNCHES["fused_attention_block"] == 1
    assert sum(fa.LAUNCHES.values()) == 3


@pytest.mark.parametrize(
    "shape, match",
    [((1, 2, 9, 48), "32 or 64"), ((1, 2, 257, 64), "N <= 256")],
    ids=["head-width", "too-many-tokens"],
)
def test_k7_refuses_shapes_the_kernel_does_not_take(device, shape, match):
    q, k, v, _ = _qkv_heads(*shape, torch.float32, device)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)


def test_k7_refuses_a_tracked_input_on_the_card(device):
    q, k, v, _ = _qkv_heads(1, 2, 9, 64, torch.float32, device)
    q.requires_grad_(True)
    fa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no gradient"):
        fa.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k8_backward_through_the_function_matches_autograd_of_the_eager_math(
        device, dtype):
    """The Function's forward launches K8 and its backward is the VJP of
    ``attention_block_xla``: the gradients equal autograd of that math."""
    p = _inputs(3, 77, 512, dtype, device, causal=True)
    names = ("x", "w_qkv", "b_qkv", "w_out", "b_out")
    dout = _dout(p)
    fa.reset_launch_counts()
    leaves = {k: p[k].detach().clone().requires_grad_(True) for k in names}
    out = _k8({**p, **leaves}, 8)
    got = torch.autograd.grad(out, list(leaves.values()), dout)
    assert fa.LAUNCHES["fused_attention_block"] == 1
    ref_leaves = [p[k].detach().clone().requires_grad_(True) for k in names]
    ref_out = fa.attention_block_xla(*ref_leaves, 8, p["mask"])
    ref = torch.autograd.grad(ref_out, ref_leaves, dout)
    for name, out_g, ref_g in zip(names, got, ref):
        _assert_grad_close(out_g, ref_g, name)
