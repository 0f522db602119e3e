"""The port's OpenAI checkpoint conversion against the JAX package's.

A random state dict in the OpenAI layout (the TEST-RN and TEST-ViT shapes,
with random BatchNorm statistics, so the folding is exercised) goes through
both ``convert_torch_state_dict``: the architectures are equal, the converted
arrays (folded BatchNorm included, both in numpy float32) are equal bit for
bit, and the image and text features agree at 5e-5. The same dict saved with
``torch.save``, and as a TorchScript archive, loads through the port's
``load_clip_resolved`` (``MODEL.INIT_WEIGHTS``, and the candidate
directories with the npz before the ``.pt``) to the features of the JAX
``load_torch_checkpoint``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from clip_gp_tpu.models import clip_loader as jcl
from clip_gp_tpu.models import clip_model as jcm
from clip_gp_tpu.models.tokenizer import tokenize
from clip_gp_tpu_torch.core.config import Config
from clip_gp_tpu_torch.models import clip_loader as tcl

ATOL = 5e-5


def openai_state_dict(arch, seed):
    """A random OpenAI CLIP state dict (ref: clip/model.py) of ``arch``'s
    shapes, as torch tensors: weights N(0, fan_in^-1/2), BatchNorm with
    random weight, bias, running mean and running variance."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(key, *shape, std=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        sd[key] = torch.randn(shape, generator=g) * (std or fan_in**-0.5)

    def bn(key, n):
        sd[f"{key}.weight"] = 1 + 0.1 * torch.randn(n, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(n, generator=g)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(n, generator=g)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(n, generator=g)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    def linear(key, cout, cin, bias=True):
        normal(f"{key}.weight", cout, cin)
        if bias:
            normal(f"{key}.bias", cout, std=0.1)

    def ln(key, n):
        sd[f"{key}.weight"] = 1 + 0.1 * torch.randn(n, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(n, generator=g)

    def resblocks(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            ln(f"{p}.ln_1", width)
            normal(f"{p}.attn.in_proj_weight", 3 * width, width)
            normal(f"{p}.attn.in_proj_bias", 3 * width, std=0.1)
            linear(f"{p}.attn.out_proj", width, width)
            ln(f"{p}.ln_2", width)
            linear(f"{p}.mlp.c_fc", 4 * width, width)
            linear(f"{p}.mlp.c_proj", width, 4 * width)

    w = arch.vision_width
    if arch.is_vit:
        ps, grid = arch.vision_patch_size, arch.image_resolution // arch.vision_patch_size
        normal("visual.conv1.weight", w, 3, ps, ps)
        normal("visual.class_embedding", w, std=w**-0.5)
        normal("visual.positional_embedding", grid**2 + 1, w)
        ln("visual.ln_pre", w)
        resblocks("visual.transformer", w, arch.vision_layers)
        ln("visual.ln_post", w)
        normal("visual.proj", w, arch.embed_dim)
    else:
        for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
            normal(f"visual.conv{i}.weight", cout, cin, 3, 3)
            bn(f"visual.bn{i}", cout)
        cin = w
        for li, n_blocks in enumerate(arch.vision_layers):
            planes = w * 2**li
            for bi in range(n_blocks):
                p = f"visual.layer{li + 1}.{bi}"
                for i, (ci, co, k) in enumerate(((cin, planes, 1), (planes, planes, 3),
                                                 (planes, planes * 4, 1)), 1):
                    normal(f"{p}.conv{i}.weight", co, ci, k, k)
                    bn(f"{p}.bn{i}", co)
                if (li > 0 and bi == 0) or cin != planes * 4:
                    normal(f"{p}.downsample.0.weight", planes * 4, cin, 1, 1)
                    bn(f"{p}.downsample.1", planes * 4)
                cin = planes * 4
        embed = w * 32
        normal("visual.attnpool.positional_embedding",
               (arch.image_resolution // 32) ** 2 + 1, embed)
        for name, cout in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                           ("c_proj", arch.embed_dim)):
            linear(f"visual.attnpool.{name}", cout, embed)
    tw = arch.transformer_width
    normal("token_embedding.weight", arch.vocab_size, tw, std=0.02)
    normal("positional_embedding", arch.context_length, tw, std=0.01)
    resblocks("transformer", tw, arch.transformer_layers)
    ln("ln_final", tw)
    normal("text_projection", tw, arch.embed_dim)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd[key] = torch.tensor(getattr(arch, key if key != "input_resolution"
                                       else "image_resolution"))
    return sd


def _numpy(sd):
    return {k: v.float().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module", params=["TEST-RN", "TEST-ViT"])
def converted(request):
    arch = jcm.ARCHITECTURES[request.param]
    sd = openai_state_dict(arch, seed=3)
    j_arch, j_params = jcl.convert_torch_state_dict(_numpy(sd))
    t_arch, t_flat = tcl.convert_torch_state_dict(_numpy(sd))
    return {"arch": arch, "sd": sd, "j_arch": j_arch, "j_params": j_params,
            "t_arch": t_arch, "t_flat": t_flat}


def _features(j_arch, j_params, model):
    res = j_arch.image_resolution
    images = np.random.default_rng(0).normal(size=(2, res, res, 3)).astype(np.float32)
    tokens = tokenize(["a photo of a red circle.", "itap of a dog."])
    expected = (np.asarray(jcm.encode_image_jit(j_params, j_arch, jnp.asarray(images))),
                np.asarray(jcm.encode_text_jit(j_params, j_arch, jnp.asarray(tokens))))
    with torch.no_grad():
        got = (model.encode_image(torch.from_numpy(images)).numpy(),
               model.encode_text(torch.from_numpy(tokens)).numpy())
    return got, expected


def test_infer_arch_matches_jax(converted):
    assert dataclasses.asdict(converted["t_arch"]) == dataclasses.asdict(converted["j_arch"])
    assert converted["t_arch"].vision_layers == converted["arch"].vision_layers


def test_converted_arrays_equal_jax(converted):
    expected = {k: np.asarray(v) for k, v in jcl._flatten(converted["j_params"]).items()}
    got = converted["t_flat"]
    assert set(got) == set(expected)
    for key, value in expected.items():
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    if not converted["arch"].is_vit:  # the folding was exercised
        assert np.abs(got["visual/layer1/0/downsample/bias"]).max() > 0.01


def test_converted_features_match_jax(converted):
    model = tcl.build_clip(converted["t_arch"], tcl.params_from_numpy(converted["t_flat"]),
                           device="cpu")
    got, expected = _features(converted["j_arch"], converted["j_params"], model)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g, e, rtol=0, atol=ATOL)


def _scripted(sd):
    """A TorchScript archive whose state dict is ``sd`` (the form OpenAI
    ships): every entry a buffer of nested submodules."""
    root = nn.Module()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        mod = root
        for name in path:
            if not hasattr(mod, name):
                mod.add_module(name, nn.Module())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, value)
    return torch.jit.script(root)


@pytest.mark.parametrize("form", ["state_dict", "torchscript"])
def test_pt_loads_through_init_weights_like_jax(converted, form, tmp_path):
    path = str(tmp_path / "model.pt")
    if form == "torchscript":
        _scripted(converted["sd"]).save(path)
    else:
        torch.save(converted["sd"], path)
    read, expected = tcl.read_torch_checkpoint(path), _numpy(converted["sd"])
    assert set(read) == set(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(read[key], value, err_msg=key)
    j_arch, j_params = jcl.load_torch_checkpoint(path)
    config = Config()
    config.model.backbone_name = converted["arch"].name
    config.model.init_weights = path
    t_arch, model, tag = tcl.load_clip_resolved(config, device="cpu")
    assert dataclasses.asdict(t_arch) == dataclasses.asdict(j_arch)
    assert tag.startswith("w")
    got, expected = _features(j_arch, j_params, model)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g, e, rtol=0, atol=ATOL)


def test_candidate_directories_take_the_npz_before_the_pt(converted, tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_WEIGHTS_DIR", raising=False)
    name = converted["arch"].name
    config = Config()
    config.model.backbone_name = name
    with pytest.raises(FileNotFoundError):
        tcl.load_clip_resolved(config, device="cpu")
    pt = tmp_path / ".cache" / "clip" / f"{name}.pt"
    pt.parent.mkdir(parents=True)
    torch.save(converted["sd"], str(pt))
    arch, model, tag = tcl.load_clip_resolved(config, device="cpu")
    assert tag == tcl._file_tag(str(pt)) and arch.name == "custom"
    npz = tmp_path / ".cache" / "clip" / f"{name}.npz"
    tcl.save_params_npz(str(npz), converted["arch"], model)
    assert tcl.load_clip_resolved(config, device="cpu")[2] == tcl._file_tag(str(npz))
