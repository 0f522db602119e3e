"""Port K3/K4 (the backward of the fused blocks) against the JAX package.

- ``ln_attn_bwd_plain`` and ``ln_mlp_bwd_plain`` (the on-card reference of
  the CUDA kernels) against the Pallas backward kernels
  ``_ln_attn_bwd_pallas`` / ``_ln_mlp_bwd_pallas`` in interpret mode on the
  same numpy inputs: all seven gradients at rtol 1e-4 / atol 1e-5, the JAX
  suite's gradient tolerance (tests/test_flash_attention.py). Odd B and a
  ragged N (3 x 11) with a causal mask, head width 64. With a bf16 ``x``
  (and bf16 weights, as the bf16 prompt tower passes them) both sides
  recompute in fp32 and round each gradient to its input's dtype at the same
  points; the gradients that come out in bf16 may differ by one bf16 ulp
  where the fp32 sums, taken in another order, straddle a rounding boundary
  (2^-7 relative, plus 2^-6 of the largest value absolute near zero).
- The autograd Functions behind ``fused_ln_attention_block`` and
  ``fused_ln_mlp``: ``torch.autograd.grad`` through them on the CPU gives
  the plain backward's gradients, asks K3/K4 for the weight gradients only
  when a weight needs one, and saves only the block's primal inputs.
- The TEST-ViT text tower: gradients of the mean squared feature (gradients
  of order one, so the absolute tolerance means what it says) with respect to
  the prompt embeddings and every tower weight, against ``jax.grad`` of
  ``clip_gp_tpu.models.clip_model.text_features_from_embeddings`` (plain
  XLA on the CPU), at atol 2e-5 as tests/test_flash_attention.py holds the
  JAX tower's two backward routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_gp_tpu.ops import flash_attention as jfa
from clip_gp_tpu_torch.ops import flash_attention as tfa

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, N, D, HEADS, HIDDEN = 3, 11, 128, 2, 512
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_NAMES = ("dx", "dln_scale", "dln_bias", "dw_qkv", "db_qkv", "dw_out", "db_out")
MLP_NAMES = ("dx", "dln_scale", "dln_bias", "dw_fc", "db_fc", "dw_proj", "db_proj")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "x": f(B, N, D), "dout": f(B, N, D),
        "ln_scale": 1 + 0.1 * f(D), "ln_bias": 0.1 * f(D),
        "w_qkv": f(D, 3 * D, scale=D**-0.5), "b_qkv": 0.1 * f(3 * D),
        "w_out": f(D, D, scale=D**-0.5), "b_out": 0.1 * f(D),
        "w_fc": f(D, HIDDEN, scale=D**-0.5), "b_fc": 0.1 * f(HIDDEN),
        "w_proj": f(HIDDEN, D, scale=HIDDEN**-0.5), "b_proj": 0.1 * f(D),
        "mask": np.triu(np.full((N, N), -np.inf, np.float32), 1),
    }


def _both(p, keys, dtype, working=("x", "dout", "w_qkv", "b_qkv", "w_out",
                                   "w_fc", "w_proj")):
    """(jax args, torch args): the working-type inputs in ``dtype``, the LN
    parameters, b_fc and the mask in fp32, as the towers pass them."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(p[k]).astype(jdt if k in working else jnp.float32) for k in keys]
    t = [torch.from_numpy(p[k]).to(tdt if k in working else torch.float32) for k in keys]
    return j, t


def _assert_grads(got, expected, names):
    for name, g, e in zip(names, got, expected):
        assert g.dtype == (torch.bfloat16 if e.dtype == jnp.bfloat16
                           else torch.float32), name
        e = np.asarray(e.astype(jnp.float32))
        tol = GRAD_TOL
        if g.dtype == torch.bfloat16:
            tol = dict(rtol=2.0**-7, atol=2.0**-6 * float(np.abs(e).max()))
        np.testing.assert_allclose(g.float().numpy(), e, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_attn_bwd_plain_matches_pallas(dtype):
    p = _inputs()
    keys = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "mask", "dout")
    (jx, jg, jb, jwq, jbq, jwo, jm, jd), args = _both(p, keys, dtype)
    expected = jfa._ln_attn_bwd_pallas(jx, jg, jb, jwq, jbq, jwo, jm, HEADS, jd,
                                       interpret=True)
    x, g, b_, wq, bq, wo, m, d = args
    got = tfa.ln_attn_bwd_plain(x, g, b_, wq, bq, wo, m, HEADS, d)
    assert got[0].dtype == x.dtype and got[3].dtype == wq.dtype
    assert got[6].dtype == torch.float32  # db_out: cast at the call site
    _assert_grads(got, expected, ATTN_NAMES)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_mlp_bwd_plain_matches_pallas(dtype):
    p = _inputs(seed=1)
    keys = ("x", "ln_scale", "ln_bias", "w_fc", "b_fc", "w_proj", "dout")
    (jx, jg, jb, jwf, jbf, jwp, jd), args = _both(p, keys, dtype)
    expected = jfa._ln_mlp_bwd_pallas(jx, jg, jb, jwf, jbf, jwp, jd, interpret=True)
    x, g, b_, wf, bf, wp, d = args
    got = tfa.ln_mlp_bwd_plain(x, g, b_, wf, bf, wp, d)
    assert got[0].dtype == x.dtype and got[3].dtype == wf.dtype
    assert got[6].dtype == torch.float32  # db_proj: cast at the call site
    _assert_grads(got, expected, MLP_NAMES)


def _attn_args(p, requires_grad):
    keys = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")
    args = [torch.from_numpy(p[k]).requires_grad_(k in requires_grad) for k in keys]
    return args, torch.from_numpy(p["mask"])


def _mlp_args(p, requires_grad):
    keys = ("x", "ln_scale", "ln_bias", "w_fc", "b_fc", "w_proj", "b_proj")
    return [torch.from_numpy(p[k]).requires_grad_(k in requires_grad) for k in keys]


def _record_param_grads(monkeypatch, name):
    calls = []
    real = getattr(tfa, name)

    def spy(*args, param_grads=True, **kwargs):
        calls.append(param_grads)
        return real(*args, param_grads=param_grads, **kwargs)

    monkeypatch.setattr(tfa, name, spy)
    return calls


ALL_ATTN = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")
ALL_MLP = ("x", "ln_scale", "ln_bias", "w_fc", "b_fc", "w_proj", "b_proj")


@pytest.mark.parametrize("wanted", [ALL_ATTN, ("x",)], ids=["all", "dx-only"])
def test_attention_autograd_runs_the_backward_kernel(monkeypatch, wanted):
    p = _inputs(seed=2)
    args, mask = _attn_args(p, wanted)
    calls = _record_param_grads(monkeypatch, "ln_attn_bwd")
    out = tfa.fused_ln_attention_block(*args, HEADS, mask)
    torch.testing.assert_close(
        out.detach(), tfa.ln_attention_block_plain(*[a.detach() for a in args],
                                                   HEADS, mask), rtol=0, atol=0)
    dout = torch.from_numpy(p["dout"])
    inputs = [a for a in args if a.requires_grad]
    got = torch.autograd.grad(out, inputs, dout)
    expected = tfa.ln_attn_bwd_plain(*[a.detach() for a in args[:6]], mask,
                                     HEADS, dout)
    expected = dict(zip(ALL_ATTN, expected))
    for name, g in zip(wanted, got):
        torch.testing.assert_close(g, expected[name], rtol=0, atol=0, msg=name)
    assert calls == [len(wanted) > 1]


@pytest.mark.parametrize("wanted", [ALL_MLP, ("x",)], ids=["all", "dx-only"])
def test_mlp_autograd_runs_the_backward_kernel(monkeypatch, wanted):
    p = _inputs(seed=3)
    args = _mlp_args(p, wanted)
    calls = _record_param_grads(monkeypatch, "ln_mlp_bwd")
    out = tfa.fused_ln_mlp(*args)
    dout = torch.from_numpy(p["dout"])
    got = torch.autograd.grad(out, [a for a in args if a.requires_grad], dout)
    expected = dict(zip(ALL_MLP, tfa.ln_mlp_bwd_plain(*[a.detach() for a in args[:6]],
                                                      dout)))
    for name, g in zip(wanted, got):
        torch.testing.assert_close(g, expected[name], rtol=0, atol=0, msg=name)
    assert calls == [len(wanted) > 1]


def test_autograd_saves_only_the_primal_inputs():
    """The Functions keep the block inputs for the backward, never qkv, the
    scores or the [T, 4D] hidden: the per-block counterpart of the JAX
    towers' jax.checkpoint."""
    p = _inputs(seed=4)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        attn_args, mask = _attn_args(p, ("x",))
        tfa.fused_ln_attention_block(*attn_args, HEADS, mask)
        mlp_args = _mlp_args(p, ("x",))
        tfa.fused_ln_mlp(*mlp_args)
    inputs = [*attn_args, mask, *mlp_args]
    assert sorted(saved) == sorted(tuple(t.shape) for t in inputs)


def test_wrappers_check_the_gradient_input():
    p = _inputs()
    x = torch.from_numpy(p["x"])
    args = [torch.from_numpy(p[k]) for k in ("ln_scale", "ln_bias", "w_fc", "b_fc",
                                             "w_proj")]
    with pytest.raises(ValueError, match="dout"):
        tfa.ln_mlp_bwd(x, *args, x[:, :-1].contiguous())
    with pytest.raises(ValueError, match="dout"):
        tfa.ln_mlp_bwd(x, *args, x.to(torch.bfloat16))


def test_text_tower_grads_match_jax(tmp_path):
    from clip_gp_tpu.models import clip_model as jcm
    from clip_gp_tpu.models.clip_loader import _flatten, init_clip_params, save_params_npz
    from clip_gp_tpu_torch.models.clip_loader import load_params_npz

    arch = jcm.ARCHITECTURES["TEST-ViT"]
    params = init_clip_params(jax.random.key(0), arch)
    path = str(tmp_path / "test_vit.npz")
    save_params_npz(path, arch, params)
    _, model = load_params_npz(path, device="cpu")
    tower_keys = ("pos_embed", "transformer", "ln_final", "text_projection")
    rng = np.random.default_rng(0)
    w = int(arch.transformer_width)
    embeds = rng.normal(size=(3, 24, w)).astype(np.float32) * 0.02
    eot = np.array([7, 23, 12])

    def jax_loss(embeds, tower):
        text = jcm.text_features_from_embeddings(tower, arch, embeds, jnp.asarray(eot))
        return jnp.mean(text**2)

    tower = {k: params[k] for k in tower_keys}
    je, jt = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(embeds), tower)
    expected = {k: np.asarray(v) for k, v in _flatten(jt).items()}

    tensors = {n: t for n, t in model.named_parameters() if n.split(".")[0] in tower_keys}
    for t in tensors.values():
        t.requires_grad_(True)
    te = torch.from_numpy(embeds).requires_grad_(True)
    loss = (model.text_features_from_embeddings(te, torch.from_numpy(eot)) ** 2).mean()
    grads = torch.autograd.grad(loss, [te, *tensors.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(je), rtol=1e-4, atol=2e-5)
    got = {}
    for name, g in zip(tensors, grads[1:]):
        key = name.replace(".", "/")
        head, sep, rest = key.partition("transformer/blocks/")
        if sep:
            layer, leaf = rest.split("/", 1)
            got.setdefault(f"{head}{sep}{leaf}", {})[int(layer)] = g.numpy()
        else:
            got[key] = g.numpy()
    got = {k: np.stack([v[i] for i in range(len(v))]) if isinstance(v, dict) else v
           for k, v in got.items()}
    assert set(got) == set(expected)
    for key, value in expected.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=2e-5, err_msg=key)
