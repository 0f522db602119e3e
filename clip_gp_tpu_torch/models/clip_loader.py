"""CLIP parameter initialization, the npz weights format and the OpenAI
checkpoint conversion.

- ``init_clip_params(arch, seed)``: random init with the reference's scale
  scheme (ref: clip/model.py:334-361) and the JAX package's shapes, for both
  tower families — for tests and chip runs without checkpoints. The draws
  come from a ``torch.Generator`` and differ from the JAX package's
  ``jax.random`` draws; parity tests load both packages from one npz instead.
- ``load_params_npz`` / ``save_params_npz``: the JAX package's on-disk format
  (``clip_gp_tpu/models/clip_loader.py:354-427``): flat ``a/b/c`` keys,
  transformer blocks stacked on a leading layer axis, ResNet blocks as list
  entries (``visual/layer1/0/conv1/w``), conv weights in HWIO, and the
  architecture under ``__meta__/``.
- ``params_from_numpy`` / ``numpy_from_params``: the weights bridge between
  that flat layout and the port's ``CLIP`` module state (blocks unstacked
  into ``blocks.<i>``, every conv weight OIHW); ``trial_state_from_numpy``:
  a JAX trial-stacked head state (the vmapped runner's [T, ...] pytree) →
  the port's trial-batched state.
- ``convert_torch_state_dict`` / ``load_torch_checkpoint``: an OpenAI
  ``.pt`` checkpoint (TorchScript archive or plain state dict) → the flat
  layout, with frozen BatchNorm folded into per-channel conv scale/bias in
  numpy float32, as the JAX package converts it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from clip_gp_tpu_torch.core.device import resolve_device
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES, CLIP, ClipArchitecture
from clip_gp_tpu_torch.runtime.checkpoint import _flatten

_BLOCKS = "transformer/blocks/"
BN_EPS = 1e-5
# the OpenAI checkpoint's scalar entries that are no parameters
_CKPT_SCALARS = ("input_resolution", "context_length", "vocab_size")


# ---------------------------------------------------------------------------
# weights bridge: flat JAX-layout numpy arrays <-> CLIP module state
# ---------------------------------------------------------------------------

def params_from_numpy(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-package params as flat numpy arrays (``save_params_npz`` keys) →
    the port's ``CLIP`` state dict. Stacked ``…/transformer/blocks/<leaf>``
    arrays [L, …] become ``….transformer.blocks.<i>.<leaf>``; every other
    4-D array is a conv weight (the patch embed, the ResNet stem, blocks and
    downsamples) and goes from HWIO to OIHW."""
    state: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        arr = np.asarray(val, dtype=np.float32)
        if _BLOCKS in key:
            head, leaf = key.split(_BLOCKS)
            for i in range(arr.shape[0]):
                name = f"{head}{_BLOCKS}{i}/{leaf}".replace("/", ".")
                state[name] = torch.tensor(arr[i])
            continue
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        state[key.replace("/", ".")] = torch.tensor(arr)
    return state


def trial_state_from_numpy(tree, device=None):
    """A JAX trial-stacked trainable state as numpy (nested dicts of
    ``[T, ...]`` arrays, the JAX vmapped runner's pytree) → the port's
    trial-batched state: the same nesting and leaf names, fp32 tensors on
    ``device`` (by default the GPU, see ``core/device.py``). The heads'
    leaves keep their layout in both packages (right-multiply ``[D, H]``
    MLPs, ``[K, ...]`` per-class GP leaves), so nothing is transposed."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: trial_state_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def numpy_from_params(model: CLIP) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``: the module's state in the JAX
    package's flat layout (blocks stacked, convs HWIO)."""
    flat: Dict[str, np.ndarray] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in model.state_dict().items():
        key = name.replace(".", "/")
        arr = t.detach().float().cpu().numpy()
        m = re.fullmatch(r"(.*transformer/blocks/)(\d+)/(.*)", key)
        if m:
            stacked.setdefault(m.group(1) + m.group(3), {})[int(m.group(2))] = arr
            continue
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        flat[key] = arr
    for key, layers in stacked.items():
        flat[key] = np.stack([layers[i] for i in range(len(layers))])
    return flat


def build_clip(arch: ClipArchitecture, state: Dict[str, torch.Tensor],
               device=None) -> CLIP:
    """A frozen ``CLIP`` module holding ``state`` on ``device`` (by default
    the GPU, see ``core/device.py``; the loaders below all end here)."""
    device = resolve_device(device)
    model = CLIP(arch)
    model.load_state_dict(state, strict=True)
    model.requires_grad_(False)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# random initialization (tests / chip runs)
# ---------------------------------------------------------------------------

def _random_flat(arch: ClipArchitecture, gen: torch.Generator) -> Dict[str, np.ndarray]:
    """JAX-layout params with ``init_clip_params``' shapes and scales
    (clip_gp_tpu/models/clip_loader.py:41-176)."""

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).numpy()

    def ones(n):
        return np.ones(n, np.float32)

    def zeros(n):
        return np.zeros(n, np.float32)

    def transformer(prefix, width, layers):
        attn_std = width**-0.5
        proj_std = attn_std * 0.1
        fc_std = (2 * width) ** -0.5
        p = prefix + _BLOCKS
        return {
            p + "ln_1/scale": np.tile(ones(width), (layers, 1)),
            p + "ln_1/bias": np.tile(zeros(width), (layers, 1)),
            p + "attn/w_qkv": normal((layers, width, 3 * width), attn_std),
            p + "attn/b_qkv": np.tile(zeros(3 * width), (layers, 1)),
            p + "attn/w_out": normal((layers, width, width), proj_std),
            p + "attn/b_out": np.tile(zeros(width), (layers, 1)),
            p + "ln_2/scale": np.tile(ones(width), (layers, 1)),
            p + "ln_2/bias": np.tile(zeros(width), (layers, 1)),
            p + "mlp/c_fc/w": normal((layers, width, 4 * width), fc_std),
            p + "mlp/c_fc/b": np.tile(zeros(4 * width), (layers, 1)),
            p + "mlp/c_proj/w": normal((layers, 4 * width, width), proj_std),
            p + "mlp/c_proj/b": np.tile(zeros(width), (layers, 1)),
        }

    def conv_bn(prefix, k, cin, cout):
        return {prefix + "w": normal((k, k, cin, cout), (k * k * cin) ** -0.5),
                prefix + "scale": ones(cout), prefix + "bias": zeros(cout)}

    def linear(prefix, cin, cout, std):
        return {prefix + "w": normal((cin, cout), std), prefix + "b": zeros(cout)}

    def resnet_visual():
        # clip_gp_tpu/models/clip_loader.py:82-144
        w = arch.vision_width
        flat = {**conv_bn("visual/conv1/", 3, 3, w // 2),
                **conv_bn("visual/conv2/", 3, w // 2, w // 2),
                **conv_bn("visual/conv3/", 3, w // 2, w)}
        cin = w
        for li, n_blocks in enumerate(arch.vision_layers):
            planes = w * 2**li
            for bi in range(n_blocks):
                p, cout = f"visual/layer{li + 1}/{bi}/", planes * 4
                flat.update({**conv_bn(p + "conv1/", 1, cin, planes),
                             **conv_bn(p + "conv2/", 3, planes, planes),
                             **conv_bn(p + "conv3/", 1, planes, cout)})
                if (li > 0 and bi == 0) or cin != cout:  # stride 2, or a new width
                    flat.update(conv_bn(p + "downsample/", 1, cin, cout))
                cin = cout
        embed = w * 32
        spacial = arch.image_resolution // 32
        std = embed**-0.5
        p = "visual/attnpool/"
        return {**flat, p + "pos_embed": normal((spacial**2 + 1, embed), std),
                **linear(p + "q_proj/", embed, embed, std),
                **linear(p + "k_proj/", embed, embed, std),
                **linear(p + "v_proj/", embed, embed, std),
                **linear(p + "c_proj/", embed, arch.embed_dim, std)}

    def vit_visual():
        w, ps = arch.vision_width, arch.vision_patch_size
        grid = arch.image_resolution // ps
        return {
            "visual/conv1/w": normal((ps, ps, 3, w), (3 * ps * ps) ** -0.5),
            "visual/class_embed": normal((w,), w**-0.5),
            "visual/pos_embed": normal((grid**2 + 1, w), w**-0.5),
            "visual/ln_pre/scale": ones(w),
            "visual/ln_pre/bias": zeros(w),
            **transformer("visual/", w, arch.vision_layers),
            "visual/ln_post/scale": ones(w),
            "visual/ln_post/bias": zeros(w),
            "visual/proj": normal((w, arch.embed_dim), w**-0.5),
        }

    tw = arch.transformer_width
    return {
        **(vit_visual() if arch.is_vit else resnet_visual()),
        "token_embedding": normal((arch.vocab_size, tw), 0.02),
        "pos_embed": normal((arch.context_length, tw), 0.01),
        **transformer("", tw, arch.transformer_layers),
        "ln_final/scale": ones(tw),
        "ln_final/bias": zeros(tw),
        "text_projection": normal((tw, arch.embed_dim), tw**-0.5),
        "logit_scale": np.asarray(np.log(1 / 0.07), dtype=np.float32),
    }


def init_clip_params(arch: ClipArchitecture, seed: int = 0, device=None) -> CLIP:
    """Randomly initialised frozen CLIP on ``device`` (draws on the CPU from
    a generator seeded with ``seed``)."""
    gen = torch.Generator().manual_seed(int(seed))
    return build_clip(arch, params_from_numpy(_random_flat(arch, gen)), device)


# ---------------------------------------------------------------------------
# npz format (byte-compatible keys with the JAX package)
# ---------------------------------------------------------------------------

def save_params_npz(path: str, arch: ClipArchitecture, model: CLIP) -> None:
    meta = {f"__meta__/{k}": np.asarray(str(v))
            for k, v in dataclasses.asdict(arch).items()}
    np.savez_compressed(path, **numpy_from_params(model), **meta)


def read_params_npz(path: str) -> Tuple[ClipArchitecture, Dict[str, np.ndarray]]:
    """(arch, flat numpy params) from an npz that either package wrote."""
    with np.load(path, allow_pickle=False) as data:
        flat, meta = {}, {}
        for k in data.files:
            if k.startswith("__meta__/"):
                meta[k[len("__meta__/"):]] = str(data[k])
            else:
                flat[k] = data[k]
    vl = meta["vision_layers"]
    vision_layers = (
        tuple(int(x) for x in re.findall(r"\d+", vl)) if vl.startswith("(") else int(vl)
    )
    arch = ClipArchitecture(
        name=meta["name"],
        embed_dim=int(meta["embed_dim"]),
        image_resolution=int(meta["image_resolution"]),
        vision_layers=vision_layers,
        vision_width=int(meta["vision_width"]),
        vision_patch_size=None if meta["vision_patch_size"] == "None"
        else int(meta["vision_patch_size"]),
        context_length=int(meta["context_length"]),
        vocab_size=int(meta["vocab_size"]),
        transformer_width=int(meta["transformer_width"]),
        transformer_heads=int(meta["transformer_heads"]),
        transformer_layers=int(meta["transformer_layers"]),
    )
    return arch, flat


def load_params_npz(path: str, device=None) -> Tuple[ClipArchitecture, CLIP]:
    arch, flat = read_params_npz(path)
    return arch, build_clip(arch, params_from_numpy(flat), device)


# ---------------------------------------------------------------------------
# OpenAI checkpoint conversion (clip_gp_tpu/models/clip_loader.py:183-350)
# ---------------------------------------------------------------------------

def infer_arch_from_state_dict(sd: Dict[str, np.ndarray]) -> ClipArchitecture:
    """Tower shapes from an OpenAI state dict's tensor shapes
    (ref: clip/model.py:450-473)."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = patch * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4)
        )
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        patch = None
        image_resolution = out_width * 32
    tw = sd["ln_final.weight"].shape[0]
    t_layers = len({k.split(".")[2] for k in sd
                    if k.startswith("transformer.resblocks")})
    return ClipArchitecture(
        name="custom",
        embed_dim=int(sd["text_projection"].shape[1]),
        image_resolution=int(image_resolution),
        vision_layers=vision_layers if patch is None else int(vision_layers),
        vision_width=int(vision_width),
        vision_patch_size=None if patch is None else int(patch),
        context_length=int(sd["positional_embedding"].shape[0]),
        vocab_size=int(sd["token_embedding.weight"].shape[0]),
        transformer_width=int(tw),
        transformer_heads=int(tw // 64),
        transformer_layers=int(t_layers),
    )


def _fold_bn(conv_w, g, b, mean, var) -> Dict[str, np.ndarray]:
    """Frozen BatchNorm folded into the conv: ``scale = g / sqrt(var + eps)``,
    ``bias = b - mean * scale``, in numpy float32 as the JAX package folds
    it; the weight goes OIHW → HWIO (the flat layout's)."""
    scale = g / np.sqrt(var + BN_EPS)
    return {"w": conv_w.transpose(2, 3, 1, 0),
            "scale": scale.astype(np.float32),
            "bias": (b - mean * scale).astype(np.float32)}


def _conv_bn(sd, conv_key: str, bn_key: str) -> Dict[str, np.ndarray]:
    return _fold_bn(sd[f"{conv_key}.weight"], sd[f"{bn_key}.weight"],
                    sd[f"{bn_key}.bias"], sd[f"{bn_key}.running_mean"],
                    sd[f"{bn_key}.running_var"])


def _ln(sd, key: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _lin(sd, key: str) -> Dict[str, np.ndarray]:
    p = {"w": sd[f"{key}.weight"].T}
    if f"{key}.bias" in sd:
        p["b"] = sd[f"{key}.bias"]
    return p


def _convert_block(sd, prefix: str) -> Dict[str, np.ndarray]:
    """One residual block, flat: ``ln_1/scale``, ``attn/w_qkv``, …"""
    return _flatten({
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "attn": {"w_qkv": sd[f"{prefix}.attn.in_proj_weight"].T,
                 "b_qkv": sd[f"{prefix}.attn.in_proj_bias"],
                 "w_out": sd[f"{prefix}.attn.out_proj.weight"].T,
                 "b_out": sd[f"{prefix}.attn.out_proj.bias"]},
        "ln_2": _ln(sd, f"{prefix}.ln_2"),
        "mlp": {"c_fc": _lin(sd, f"{prefix}.mlp.c_fc"),
                "c_proj": _lin(sd, f"{prefix}.mlp.c_proj")},
    })


def _convert_transformer(sd, prefix: str, layers: int) -> Dict[str, np.ndarray]:
    """The blocks ``<prefix>.resblocks.<i>`` stacked on a leading layer axis,
    flat under ``transformer/blocks/``."""
    blocks = [_convert_block(sd, f"{prefix}.resblocks.{i}") for i in range(layers)]
    return {_BLOCKS + leaf: np.stack([b[leaf] for b in blocks]) for leaf in blocks[0]}


def convert_torch_state_dict(
    sd: Dict[str, np.ndarray],
) -> Tuple[ClipArchitecture, Dict[str, np.ndarray]]:
    """An OpenAI CLIP state dict (numpy-valued) → (arch, params in the JAX
    package's flat layout, the keys ``save_params_npz`` writes)."""
    sd = {k: np.asarray(v, dtype=np.float32) for k, v in sd.items()
          if k not in _CKPT_SCALARS}
    arch = infer_arch_from_state_dict(sd)
    if arch.is_vit:
        visual = {
            "conv1": {"w": sd["visual.conv1.weight"].transpose(2, 3, 1, 0)},
            "class_embed": sd["visual.class_embedding"],
            "pos_embed": sd["visual.positional_embedding"],
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": sd["visual.proj"],
        }
        blocks = _convert_transformer(sd, "visual.transformer", arch.vision_layers)
    else:
        visual = {f"conv{i}": _conv_bn(sd, f"visual.conv{i}", f"visual.bn{i}")
                  for i in (1, 2, 3)}
        for li, n_blocks in enumerate(arch.vision_layers):
            visual[f"layer{li + 1}"] = layer = []
            for bi in range(n_blocks):
                pre = f"visual.layer{li + 1}.{bi}"
                layer.append({f"conv{i}": _conv_bn(sd, f"{pre}.conv{i}", f"{pre}.bn{i}")
                              for i in (1, 2, 3)})
                if f"{pre}.downsample.0.weight" in sd:
                    layer[-1]["downsample"] = _conv_bn(sd, f"{pre}.downsample.0",
                                                       f"{pre}.downsample.1")
        visual["attnpool"] = {
            "pos_embed": sd["visual.attnpool.positional_embedding"],
            **{name: _lin(sd, f"visual.attnpool.{name}")
               for name in ("q_proj", "k_proj", "v_proj", "c_proj")},
        }
        blocks = {}
    flat = _flatten({
        "visual": visual,
        "token_embedding": sd["token_embedding.weight"],
        "pos_embed": sd["positional_embedding"],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
        "logit_scale": sd["logit_scale"].reshape(()),
    })
    flat.update({f"visual/{k}": v for k, v in blocks.items()})
    flat.update(_convert_transformer(sd, "transformer", arch.transformer_layers))
    return arch, flat


def read_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """An OpenAI ``.pt`` file's state dict as float32 numpy arrays: a
    TorchScript archive through ``torch.jit.load``, else a plain state dict
    through ``torch.load`` with ``weights_only`` (tensors only, nothing
    unpickled that could run code). Both read onto the CPU."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def load_torch_checkpoint(path: str, device=None) -> Tuple[ClipArchitecture, CLIP]:
    """(arch, frozen model on ``device``) from an OpenAI ``.pt`` checkpoint."""
    arch, flat = convert_torch_state_dict(read_torch_checkpoint(path))
    return arch, build_clip(arch, params_from_numpy(flat), device)


# ---------------------------------------------------------------------------
# top-level resolution
# ---------------------------------------------------------------------------

def _candidate_paths(backbone: str):
    """``$CLIP_GP_TPU_TORCH_WEIGHTS_DIR``, ``~/.cache/clip_gp_tpu`` and
    ``~/.cache/clip`` (the OpenAI download cache), each the npz before the
    ``.pt``, and the ``.pt`` also under OpenAI's own file name where it
    differs (``ViT-L-14-336px.pt`` for ``ViT-L/14@336px``)."""
    safe = backbone.replace("/", "-")
    openai = safe.replace("@", "-")
    dirs = []
    if os.environ.get("CLIP_GP_TPU_TORCH_WEIGHTS_DIR"):
        dirs.append(Path(os.environ["CLIP_GP_TPU_TORCH_WEIGHTS_DIR"]))
    dirs += [Path.home() / ".cache" / "clip_gp_tpu", Path.home() / ".cache" / "clip"]
    for d in dirs:
        yield d / f"{safe}.npz"
        yield d / f"{safe}.pt"
        if openai != safe:
            yield d / f"{openai}.pt"


def _file_tag(path: str) -> str:
    """Weights identity from the resolved file (path + mtime + size)."""
    st = os.stat(path)
    raw = f"{path}|{st.st_mtime_ns}|{st.st_size}".encode()
    return "w" + hashlib.sha256(raw).hexdigest()[:12]


def load_clip_resolved(
    config, allow_random: bool = False, seed: int = 0, device=None
) -> Tuple[ClipArchitecture, CLIP, str]:
    """(arch, frozen model on ``device``, weights tag) for
    ``config.model.backbone_name``: ``MODEL.INIT_WEIGHTS`` (an npz, else an
    OpenAI ``.pt``), else the first file of ``_candidate_paths``, else (with
    ``allow_random`` or ``CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS=1``) random
    weights from ``seed``."""
    backbone = config.model.backbone_name
    init: Optional[str] = config.model.init_weights
    paths = [Path(init)] if init else [p for p in _candidate_paths(backbone)
                                       if p.exists()]
    if paths:
        path = str(paths[0])
        load = load_params_npz if path.endswith(".npz") else load_torch_checkpoint
        return (*load(path, device), _file_tag(path))
    if allow_random or os.environ.get("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS") == "1":
        arch = ARCHITECTURES[backbone]
        return arch, init_clip_params(arch, seed, device), f"rand{seed}"
    raise FileNotFoundError(
        f"No CLIP weights found for backbone {backbone!r}. Provide "
        "MODEL.INIT_WEIGHTS (npz or OpenAI .pt), set "
        "$CLIP_GP_TPU_TORCH_WEIGHTS_DIR, or place the OpenAI checkpoint under "
        "~/.cache/clip/. Set CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS=1 to run "
        "with random weights."
    )
