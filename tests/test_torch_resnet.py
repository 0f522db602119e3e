"""The port's ModifiedResNet tower against the JAX package.

Both packages load one npz written by the JAX ``save_params_npz`` (random
weights from ``jax.random``); the same numpy images go through the JAX
functions (jitted) and the port's modules, fp32, held at 5e-5 as
tests/test_torch_clip_model.py holds the ViT tower:

- ``Bottleneck`` against JAX ``bottleneck`` on a narrow arch (width 8,
  layers (2, 2, 2, 2), 64 px), whose blocks cover a downsample at stride 1
  (layer 1, block 0: the width changes), identity blocks and a downsample at
  stride 2 (layer 2, block 0); ``AttentionPool`` against ``attention_pool``;
  ``encode_image`` on TEST-RN and on that arch;
- the npz between the packages, key for key and array for array, and the
  random init's shapes and scales;
- ``encode_image_all_layers`` and ``clip_forward`` on TEST-ViT;
- the trainer base's load-time warning for ``MODEL.INT8_INFERENCE`` on an RN
  tower, which keeps the fp32 tower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_gp_tpu.models import clip_model as jcm
from clip_gp_tpu.models.clip_loader import _flatten, init_clip_params, save_params_npz
from clip_gp_tpu_torch.core.config import Config
from clip_gp_tpu_torch.models import clip_loader as tcl
from clip_gp_tpu_torch.models import clip_model as tcm
from clip_gp_tpu_torch.runtime.trainer_base import BaseTrainer

NARROW = jcm.ClipArchitecture("TEST-RN-2222", 32, 64, (2, 2, 2, 2), 8, None,
                              transformer_width=64, transformer_heads=1,
                              transformer_layers=2)
ARCHS = {"TEST-RN": jcm.ARCHITECTURES["TEST-RN"], "narrow": NARROW,
         "TEST-ViT": jcm.ARCHITECTURES["TEST-ViT"]}
ATOL = 5e-5


def random_params(arch, seed):
    """JAX-package params of ``arch`` (the shapes of its ``init_clip_params``)
    drawn with numpy, which is much quicker on the CPU than ``jax.random``'s
    init of a ResNet: weights N(0, fan_in^-1/2), scales near 1 and biases
    near 0, so that the folded BatchNorm's scale and bias both matter."""
    shapes = jax.eval_shape(lambda k: init_clip_params(k, arch), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", None), leaf.shape
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        if name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "b", "b_qkv", "b_out"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = np.prod(shape[:-1]) if len(shape) == 4 else shape[-2] if len(shape) > 1 else shape[0]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = {}
    base = tmp_path_factory.mktemp("weights")
    for seed, (name, arch) in enumerate(ARCHS.items()):
        params = random_params(arch, seed)
        path = str(base / f"{name}.npz")
        save_params_npz(path, arch, params)
        t_arch, model = tcl.load_params_npz(path, device="cpu")
        out[name] = {"arch": arch, "params": params, "path": path,
                     "t_arch": t_arch, "model": model}
    return out


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("layer,block,stride,downsample", [
    (1, 0, 1, True), (1, 1, 1, False), (2, 0, 2, True), (2, 1, 1, False)],
    ids=["stride1-downsample", "stride1-identity", "stride2-downsample",
         "stride1-identity-wide"])
def test_bottleneck_matches_jax(weights, layer, block, stride, downsample):
    w = weights["narrow"]
    mod = getattr(w["model"].visual, f"layer{layer}")[block]
    assert mod.stride == stride and (mod.downsample is not None) == downsample
    cin = mod.conv1.w.shape[1]
    x = _normal((2, 8, 8, cin), 0)
    expected = jcm.bottleneck(w["params"]["visual"][f"layer{layer}"][block],
                              jnp.asarray(x), stride)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL)


def test_attention_pool_matches_jax(weights):
    w = weights["narrow"]
    x = _normal((3, 2, 2, 256), 1)
    expected = jcm.attention_pool(w["params"]["visual"]["attnpool"],
                                  jnp.asarray(x), NARROW.vision_heads)
    with torch.no_grad():
        got = w["model"].visual.attnpool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=ATOL)


def test_avg_pool_matches_jax():
    x = _normal((2, 6, 6, 5), 2)
    expected = jcm.avg_pool(jnp.asarray(x), 2)
    got = tcm.avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["TEST-RN", "narrow"])
def test_encode_image_matches_jax(weights, name):
    w = weights[name]
    assert dataclasses.asdict(w["t_arch"]) == dataclasses.asdict(w["arch"])
    res = w["arch"].image_resolution
    images = _normal((3, res, res, 3), 3)
    expected = np.asarray(jcm.encode_image_jit(w["params"], w["arch"],
                                               jnp.asarray(images)))
    with torch.no_grad():
        got = w["model"].encode_image(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, w["arch"].embed_dim)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["TEST-RN", "narrow"])
def test_npz_round_trip_between_packages(weights, name, tmp_path):
    w = weights[name]
    flat = {k: np.asarray(v) for k, v in _flatten(w["params"]).items()}
    state = tcl.params_from_numpy(flat)
    # list-indexed ResNet blocks, every conv OIHW
    assert state["visual.layer1.0.conv1.w"].shape == (8, 8, 1, 1)
    assert state["visual.layer1.0.downsample.w"].shape == (32, 8, 1, 1)
    assert state["visual.conv2.w"].shape == (4, 4, 3, 3)
    path = str(tmp_path / "port.npz")
    tcl.save_params_npz(path, w["t_arch"], w["model"])
    with np.load(w["path"]) as a, np.load(path) as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_random_init_shapes_and_scales_match_jax(weights):
    arch = tcm.ARCHITECTURES["TEST-RN"]
    model = tcl.init_clip_params(arch, seed=0, device="cpu")
    port = tcl.numpy_from_params(model)
    ref = _flatten(weights["TEST-RN"]["params"])
    assert {k: v.shape for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    # the JAX init's scales (clip_gp_tpu/models/clip_loader.py:82-144)
    for key, std in (("visual/conv1/w", 27**-0.5), ("visual/layer1/0/conv2/w", 72**-0.5),
                     ("visual/attnpool/pos_embed", 256**-0.5),
                     ("visual/attnpool/c_proj/w", 256**-0.5)):
        np.testing.assert_allclose(port[key].std(), std, rtol=0.1, err_msg=key)
    for key, value in (("visual/conv1/scale", 1.0), ("visual/layer1/0/downsample/bias", 0.0),
                       ("visual/attnpool/q_proj/b", 0.0)):
        np.testing.assert_array_equal(port[key], np.full_like(port[key], value), err_msg=key)


def test_encode_image_all_layers_matches_jax(weights):
    w = weights["TEST-ViT"]
    images = _normal((2, 32, 32, 3), 4)
    expected = np.asarray(jax.jit(jcm.encode_image_all_layers, static_argnums=1)(
        w["params"], w["arch"], jnp.asarray(images)))
    with torch.no_grad():
        got = w["model"].encode_image_all_layers(torch.from_numpy(images))
        last = w["model"].encode_image(torch.from_numpy(images))
    assert got.shape == (w["arch"].vision_layers, 2, w["arch"].embed_dim)
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)
    torch.testing.assert_close(got[-1], last, rtol=0, atol=0)
    with pytest.raises(ValueError):
        weights["TEST-RN"]["model"].encode_image_all_layers(torch.zeros(1, 64, 64, 3))


def test_clip_forward_matches_jax(weights):
    from clip_gp_tpu.models.tokenizer import tokenize

    w = weights["TEST-ViT"]
    images = _normal((3, 32, 32, 3), 5)
    tokens = tokenize(["a photo of a red circle.", "itap of a dog."])
    expected = jax.jit(jcm.clip_forward, static_argnums=1)(
        w["params"], w["arch"], jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        got = tcm.clip_forward(w["model"], torch.from_numpy(images),
                               torch.from_numpy(tokens))
    # the towers' 5e-5 on a cosine, times the logit scale
    atol = ATOL * float(np.exp(w["params"]["logit_scale"]))
    for g, e in zip(got, expected):
        assert tuple(g.shape) == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=atol)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "fp32"])
def test_int8_request_on_an_rn_tower_warns_and_runs_fp32(int8, capsys):
    config = Config()
    config.model.backbone_name = "TEST-RN"
    config.model.int8_inference = int8
    trainer = BaseTrainer.__new__(BaseTrainer)
    trainer.config, trainer.device = config, torch.device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
        trainer.load_clip_model()
    out = capsys.readouterr().out
    warning = ("[WARN] MODEL.INT8_INFERENCE covers the ViT towers only; "
               "falling back to fp32 for TEST-RN")
    assert (warning in out) == int8
    assert trainer._int8_effective() is False
    assert trainer._encode_plan()["int8"] is False
