"""Plain reference of the OpenAI CLIP towers (Radford et al. 2021,
github.com/openai/CLIP ``clip/model.py``): the ModifiedResNet and ViT image
towers and the causal text tower, in plain PyTorch in any dtype, with the
weights drawn from the seed.

The weights are the random initialisation that the port draws when it has
no checkpoint (``CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS=1``): CLIP's own
scales (``initialize_parameters``), every tensor drawn in turn from one
CPU ``torch.Generator`` seeded with the run's seed, in the order below, and
frozen BatchNorm folded to scale 1 and bias 0. The benchmark hands both
sides the seed; this module draws the same numbers again itself.

Layouts: linear weights right-multiply (``x @ w``), ``w_qkv`` packs q, k, v
along its columns, conv weights are drawn HWIO and used OIHW.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.tokenizer import tokenize

Weights = Dict[str, torch.Tensor]


def _transformer(draw, prefix: str, width: int, layers: int, out: Weights) -> None:
    attn_std = width ** -0.5
    proj_std = attn_std * 0.1
    fc_std = (2 * width) ** -0.5
    out[prefix + "w_qkv"] = draw((layers, width, 3 * width), attn_std)
    out[prefix + "w_out"] = draw((layers, width, width), proj_std)
    out[prefix + "c_fc"] = draw((layers, width, 4 * width), fc_std)
    out[prefix + "c_proj"] = draw((layers, 4 * width, width), proj_std)


def random_weights(cfg: dict, seed: int) -> Weights:
    """Every drawn tensor of the architecture ``cfg`` (a configuration file
    of ``port_bench/configs``), fp32 on the CPU. Biases, LayerNorm and
    folded-BN parameters are the constants 0 and 1 and are not stored."""
    gen = torch.Generator().manual_seed(int(seed))
    w: Weights = {}

    def draw(shape, std):
        return torch.randn(shape, generator=gen) * std

    if cfg["vision_patch_size"]:
        vw, ps = cfg["vision_width"], cfg["vision_patch_size"]
        grid = cfg["image_resolution"] // ps
        w["v.conv1"] = draw((ps, ps, 3, vw), (3 * ps * ps) ** -0.5)
        w["v.class"] = draw((vw,), vw ** -0.5)
        w["v.pos"] = draw((grid ** 2 + 1, vw), vw ** -0.5)
        _transformer(draw, "v.", vw, cfg["vision_layers"], w)
        w["v.proj"] = draw((vw, cfg["embed_dim"]), vw ** -0.5)
    else:
        vw = cfg["vision_width"]

        def conv(name, k, cin, cout):
            w[name] = draw((k, k, cin, cout), (k * k * cin) ** -0.5)

        conv("v.conv1", 3, 3, vw // 2)
        conv("v.conv2", 3, vw // 2, vw // 2)
        conv("v.conv3", 3, vw // 2, vw)
        cin = vw
        for li, n_blocks in enumerate(cfg["vision_layers"]):
            planes = vw * 2 ** li
            for bi in range(n_blocks):
                p, cout = f"v.l{li}.{bi}.", planes * 4
                conv(p + "conv1", 1, cin, planes)
                conv(p + "conv2", 3, planes, planes)
                conv(p + "conv3", 1, planes, cout)
                if (li > 0 and bi == 0) or cin != cout:
                    conv(p + "down", 1, cin, cout)
                cin = cout
        embed = vw * 32
        std = embed ** -0.5
        w["v.pool_pos"] = draw(((cfg["image_resolution"] // 32) ** 2 + 1, embed), std)
        for name in ("q", "k", "v"):
            w[f"v.pool_{name}"] = draw((embed, embed), std)
        w["v.pool_c"] = draw((embed, cfg["embed_dim"]), std)
    tw = cfg["transformer_width"]
    w["t.tok"] = draw((cfg["vocab_size"], tw), 0.02)
    w["t.pos"] = draw((cfg["context_length"], tw), 0.01)
    _transformer(draw, "t.", tw, cfg["transformer_layers"], w)
    w["t.proj"] = draw((tw, cfg["embed_dim"]), tw ** -0.5)
    return w


def to_device(w: Weights, device, dtype) -> Weights:
    return {k: v.to(device=device, dtype=dtype) for k, v in w.items()}


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-5)


def _blocks(w: Weights, prefix: str, x: torch.Tensor, heads: int, mask=None):
    layers = w[prefix + "w_qkv"].shape[0]
    b, n, d = x.shape
    hd = d // heads
    for i in range(layers):
        q, k, v = (_ln(x) @ w[prefix + "w_qkv"][i]).split(d, dim=-1)
        q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2) for t in (q, k, v))
        s = q @ k.transpose(-1, -2) / hd ** 0.5
        if mask is not None:
            s = s + mask
        a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, n, d)
        x = x + a @ w[prefix + "w_out"][i]
        h = _ln(x) @ w[prefix + "c_fc"][i]
        x = x + (h * torch.sigmoid(1.702 * h)) @ w[prefix + "c_proj"][i]
    return x


# CLIP's initial logit scale, log(1 / 0.07), as the float32 it is stored in
LOGIT_SCALE = math.exp(float(np.float32(math.log(1 / 0.07))))


def encode_text(w: Weights, cfg: dict, prompts: Sequence[str]) -> torch.Tensor:
    """[len(prompts), embed_dim] features of the prompts."""
    dev, dt = w["t.tok"].device, w["t.tok"].dtype
    tokens = torch.from_numpy(tokenize(list(prompts), cfg["context_length"])).to(dev).long()
    n = tokens.shape[1]
    x = w["t.tok"][tokens] + w["t.pos"]
    mask = torch.full((n, n), float("-inf"), dtype=dt, device=dev).triu(1)
    x = _ln(_blocks(w, "t.", x, cfg["transformer_heads"], mask))
    return x[torch.arange(x.shape[0], device=dev), tokens.argmax(-1)] @ w["t.proj"]


@torch.no_grad()
def encode_templates(w: Weights, cfg: dict, classnames: Sequence[str],
                     templates: Sequence[str], chunk: int = 200) -> torch.Tensor:
    """[K, M, embed_dim] features of every class under every template."""
    prompts = [t.format(c) for c in classnames for t in templates]
    feats = torch.cat([encode_text(w, cfg, prompts[i:i + chunk])
                       for i in range(0, len(prompts), chunk)])
    return feats.reshape(len(classnames), len(templates), -1)


def _conv(w, x, name, stride=1, padding=0):
    return F.conv2d(x, w[name].permute(3, 2, 0, 1), stride=stride, padding=padding)


def _resnet(w: Weights, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(_conv(w, x, "v.conv1", stride=2, padding=1))
    x = F.relu(_conv(w, x, "v.conv2", padding=1))
    x = F.avg_pool2d(F.relu(_conv(w, x, "v.conv3", padding=1)), 2)
    for li, n_blocks in enumerate(cfg["vision_layers"]):
        for bi in range(n_blocks):
            p = f"v.l{li}.{bi}."
            stride = 2 if li > 0 and bi == 0 else 1
            out = F.relu(_conv(w, x, p + "conv1"))
            out = F.relu(_conv(w, out, p + "conv2", padding=1))
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out = _conv(w, out, p + "conv3")
            if p + "down" in w:
                x = _conv(w, F.avg_pool2d(x, stride) if stride > 1 else x, p + "down")
            x = F.relu(out + x)
    tokens = x.flatten(2).transpose(1, 2)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + w["v.pool_pos"]
    b, n, d = tokens.shape
    heads = cfg["vision_width"] * 32 // 64
    hd = d // heads
    q = (tokens[:, :1] @ w["v.pool_q"]).reshape(b, 1, heads, hd).transpose(1, 2)
    k = (tokens @ w["v.pool_k"]).reshape(b, n, heads, hd).transpose(1, 2)
    v = (tokens @ w["v.pool_v"]).reshape(b, n, heads, hd).transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1) @ v
    return a.transpose(1, 2).reshape(b, d) @ w["v.pool_c"]


def _vit(w: Weights, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    ps = cfg["vision_patch_size"]
    x = _conv(w, x, "v.conv1", stride=ps).flatten(2).transpose(1, 2)
    cls = w["v.class"].expand(x.shape[0], 1, -1)
    x = _ln(torch.cat([cls, x], dim=1) + w["v.pos"])
    x = _blocks(w, "v.", x, cfg["vision_width"] // 64)
    return _ln(x[:, 0]) @ w["v.proj"]


MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def encode_images(w: Weights, cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC images → [B, embed_dim]: scale to [0, 1], normalise with
    CLIP's mean and std, then the image tower."""
    dt = w["t.tok"].dtype
    x = images_u8.to(dt) / 255.0
    x = (x - torch.tensor(MEAN, dtype=dt, device=x.device)) / torch.tensor(STD, dtype=dt, device=x.device)
    x = x.permute(0, 3, 1, 2)
    return _vit(w, cfg, x) if cfg["vision_patch_size"] else _resnet(w, cfg, x)


@torch.no_grad()
def encode_image_array(w: Weights, cfg: dict, images: np.ndarray, batch: int = 128) -> torch.Tensor:
    """Features of uint8 NHWC images, in batches, on the CPU."""
    dev = w["t.tok"].device
    return torch.cat([encode_images(w, cfg, torch.from_numpy(images[i:i + batch]).to(dev)).cpu()
                      for i in range(0, len(images), batch)])
