"""CLIP encoders as PyTorch modules (ref: clip/model.py).

The ModifiedResNet and ViT image towers and the causal text tower, held
against the JAX package's ``clip_gp_tpu/models/clip_model.py``: the same
architectures, parameter names and layouts (right-multiply ``w_qkv [D, 3D]``
packing, frozen BatchNorm folded into per-channel ``scale``/``bias``, NHWC
images at the public functions), and the same numerics (LayerNorm and
softmax in fp32 whatever the compute dtype). Every transformer residual block
runs K1 then K2
(``ops/flash_attention.py``): hand-written CUDA kernels on a GPU, their plain
PyTorch versions on the CPU. The text tower is differentiable: the prompt
learners (CoOp, CoCoOp) backpropagate through it to their context vectors,
and each block's backward runs K4 then K3.

The ViT tower's block body can be swapped while its stem and epilogue stay
shared: the int8 serving tower (``models/quantized.py``) runs K5 then K6 in
every block through that hook.

The ModifiedResNet tower (RN50…RN50x16) has no kernel of its own in either
package: its convolutions are ``F.conv2d`` (cuDNN in fp32 on a GPU, with
TF32 off, see ``core/device.py``) and its attention pool is the plain
``multi_head_attention`` below, as the JAX package runs them through XLA.
Internally it is NCHW with OIHW weights; the input is permuted once at the
tower's entry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from clip_gp_tpu_torch.ops.flash_attention import (
    fused_ln_attention_block,
    fused_ln_mlp,
    layer_norm_f32,
)


@dataclasses.dataclass(frozen=True)
class ClipArchitecture:
    """Static architecture description (ref: clip/model.py:278-331)."""

    name: str
    embed_dim: int
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64


ARCHITECTURES: Dict[str, ClipArchitecture] = {
    "RN50": ClipArchitecture("RN50", 1024, 224, (3, 4, 6, 3), 64, None,
                             transformer_width=512, transformer_heads=8),
    "RN101": ClipArchitecture("RN101", 512, 224, (3, 4, 23, 3), 64, None,
                              transformer_width=512, transformer_heads=8),
    "RN50x4": ClipArchitecture("RN50x4", 640, 288, (4, 6, 10, 6), 80, None,
                               transformer_width=640, transformer_heads=10),
    "RN50x16": ClipArchitecture("RN50x16", 768, 384, (6, 8, 18, 8), 96, None,
                                transformer_width=768, transformer_heads=12),
    "ViT-B/32": ClipArchitecture("ViT-B/32", 512, 224, 12, 768, 32,
                                 transformer_width=512, transformer_heads=8),
    "ViT-B/16": ClipArchitecture("ViT-B/16", 512, 224, 12, 768, 16,
                                 transformer_width=512, transformer_heads=8),
    # 577 image tokens: K1's key-tiled attention core
    "ViT-L/14@336px": ClipArchitecture("ViT-L/14@336px", 768, 336, 24, 1024, 14,
                                       transformer_width=768, transformer_heads=12),
    # tiny towers for CPU tests and CI — not real CLIP checkpoints
    "TEST-ViT": ClipArchitecture("TEST-ViT", 32, 32, 2, 64, 8,
                                 transformer_width=64, transformer_heads=1,
                                 transformer_layers=2),
    "TEST-RN": ClipArchitecture("TEST-RN", 32, 64, (1, 1, 1, 1), 8, None,
                                transformer_width=64, transformer_heads=1,
                                transformer_layers=2),
}


def _param(*shape) -> nn.Parameter:
    """Uninitialised parameter: every model is filled from a flat state
    (clip_loader), never used as constructed."""
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def layer_norm(ln: "LayerNorm", x: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm with cast back to the input dtype."""
    return layer_norm_f32(x, ln.scale, ln.bias).to(x.dtype)


def multi_head_attention(q, k, v, num_heads: int, mask=None) -> torch.Tensor:
    """Batched MHA core in plain PyTorch. q: [B,Nq,D], k/v: [B,Nk,D]; fp32
    softmax. Only the ModifiedResNet attention-pool uses it; the transformer
    blocks go through K1."""
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = d // num_heads
    q = q.reshape(b, nq, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, nk, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, nk, num_heads, hd).transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)) / torch.tensor(hd**0.5, dtype=q.dtype)
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return (weights @ v).transpose(1, 2).reshape(b, nq, d)


class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.scale = _param(width)
        self.bias = _param(width)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = _param(cin, cout)
        self.b = _param(cout)


class Attention(nn.Module):
    """Torch MultiheadAttention packing in right-multiply form."""

    def __init__(self, width: int):
        super().__init__()
        self.w_qkv = _param(width, 3 * width)
        self.b_qkv = _param(3 * width)
        self.w_out = _param(width, width)
        self.b_out = _param(width)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual block (ref: clip/model.py:172-193): K1 then K2, the
    dispatch of ``attention_block`` in the JAX package."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(width)
        self.attn = Attention(width)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width)
        self._cast: Dict[torch.dtype, Tuple[torch.Tensor, ...]] = {}

    def _weights(self, dt: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(w_qkv, b_qkv, w_out, b_out, c_fc.w, c_proj.w) in the working type.
        Frozen weights are copied to another dtype once and the copy is kept
        until the module is loaded or moved again; a weight that autograd
        tracks is cast on every call, so its gradient reaches it."""
        a, m = self.attn, self.mlp
        src = (a.w_qkv, a.b_qkv, a.w_out, a.b_out, m.c_fc.w, m.c_proj.w)
        if torch.is_grad_enabled() and any(t.requires_grad for t in src):
            return tuple(t.to(dt) for t in src)
        if dt in self._cast:
            return self._cast[dt]
        w = tuple(t.to(dt) for t in src)
        if dt != a.w_qkv.dtype:
            self._cast[dt] = w
        return w

    def _apply(self, *args, **kwargs):
        self._cast.clear()
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._cast.clear()
        super()._load_from_state_dict(*args, **kwargs)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        w_qkv, b_qkv, w_out, b_out, w_fc, w_proj = self._weights(x.dtype)
        x = fused_ln_attention_block(
            x, self.ln_1.scale, self.ln_1.bias, w_qkv, b_qkv, w_out, b_out,
            self.heads, mask,
        )
        return fused_ln_mlp(
            x, self.ln_2.scale, self.ln_2.bias, w_fc, self.mlp.c_fc.b, w_proj,
            self.mlp.c_proj.b,
        )


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers)
        )

    def forward(self, x, mask=None):
        for block in self.blocks:
            x = block(x, mask)
        return x


class Conv(nn.Module):
    """Conv weight, stored OIHW (the JAX params hold HWIO)."""

    def __init__(self, cout: int, cin: int, k: int):
        super().__init__()
        self.w = _param(cout, cin, k, k)


class ConvBN(Conv):
    """Conv with its frozen BatchNorm folded into per-channel ``scale`` and
    ``bias`` (ref: clip/model.py:10-53; the folding is ``clip_loader._fold_bn``)."""

    def __init__(self, cout: int, cin: int, k: int):
        super().__init__(cout, cin, k)
        self.scale = _param(cout)
        self.bias = _param(cout)

    def forward(self, x: torch.Tensor, stride: int = 1, padding: int = 0):
        """NCHW ``x`` → conv, then ``* scale + bias`` in that order, as the
        JAX ``conv2d``."""
        dt = x.dtype
        y = F.conv2d(x, self.w.to(dt), stride=stride, padding=padding)
        return y * self.scale.to(dt)[:, None, None] + self.bias.to(dt)[:, None, None]


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping NCHW average pool: the window sum, then one division
    by ``window²``, in the JAX ``avg_pool``'s order."""
    return F.avg_pool2d(x, window, divisor_override=1) / (window * window)


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

class VisionTransformer(nn.Module):
    """ViT image tower (ref: clip/model.py:207-262)."""

    def __init__(self, arch: ClipArchitecture):
        super().__init__()
        w, ps = arch.vision_width, arch.vision_patch_size
        grid = arch.image_resolution // ps
        self.patch_size = ps
        self.heads = arch.vision_heads
        self.conv1 = Conv(w, 3, ps)
        self.class_embed = _param(w)
        self.pos_embed = _param(grid**2 + 1, w)
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, arch.vision_layers, self.heads)
        self.ln_post = LayerNorm(w)
        self.proj = _param(w, arch.embed_dim)

    def forward(self, images: torch.Tensor, block_fn: Optional[Callable] = None,
                block_params: Optional[Sequence] = None) -> torch.Tensor:
        """images: NHWC [B,R,R,3] in the compute dtype → [B, embed_dim].

        ``block_fn(block_params[i], x, num_heads)`` overrides the residual
        block body, layer by layer, while the stem and epilogue (patch conv,
        class/pos embeds, ln_pre, ln_post, proj) stay shared: the int8 tower
        (``models/quantized.py``) plugs in here, as it does through the JAX
        ``vision_transformer(..., block_fn=...)``."""
        x = self.stem(images)
        if block_fn is None:
            x = self.transformer(x)
        else:
            for p in block_params:
                x = block_fn(p, x, self.heads)
        return self.head(x)

    def stem(self, images: torch.Tensor) -> torch.Tensor:
        """Patch conv, class and position embeddings, ln_pre → [B, grid²+1, W]."""
        dt = images.dtype
        x = F.conv2d(images.permute(0, 3, 1, 2), self.conv1.w.to(dt),
                     stride=self.patch_size)  # [B, W, grid, grid]
        b, w = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # [B, grid², W], row-major patches
        cls = self.class_embed.to(dt).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        return layer_norm(self.ln_pre, x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """ln_post and the projection of the class token → [B, embed_dim]."""
        return layer_norm(self.ln_post, x[:, 0]) @ self.proj.to(x.dtype)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (ref: clip/model.py:10-53): a stride goes
    through an average pool after conv2, and the downsample branch (present
    iff ``stride > 1`` or the width changes) is an average pool, then a 1x1
    conv."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        cout = planes * 4
        self.stride = stride
        self.conv1 = ConvBN(planes, cin, 1)
        self.conv2 = ConvBN(planes, planes, 3)
        self.conv3 = ConvBN(cout, planes, 1)
        self.downsample = (ConvBN(cout, cin, 1) if stride > 1 or cin != cout
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out, padding=1))
        if self.stride > 1:
            out = avg_pool(out, self.stride)
        out = self.conv3(out)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = avg_pool(x, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


class AttentionPool(nn.Module):
    """Attention pooling (ref: clip/model.py:56-90): the mean token, prepended
    to the spatial tokens, queries all of them; only that output row is
    computed, as in the JAX ``attention_pool``."""

    def __init__(self, spacial: int, embed: int, out_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.pos_embed = _param(spacial**2 + 1, embed)
        self.q_proj = Linear(embed, embed)
        self.k_proj = Linear(embed, embed)
        self.v_proj = Linear(embed, embed)
        self.c_proj = Linear(embed, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW ``x`` → [B, out_dim]."""
        dt = x.dtype
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C], row-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.pos_embed.to(dt)

        def linear(p, t):
            return t @ p.w.to(dt) + p.b.to(dt)

        q = linear(self.q_proj, tokens[:, :1])
        k = linear(self.k_proj, tokens)
        v = linear(self.v_proj, tokens)
        pooled = multi_head_attention(q, k, v, self.heads)
        return linear(self.c_proj, pooled)[:, 0]


class ModifiedResNet(nn.Module):
    """ResNet image tower (ref: clip/model.py:93-155): a 3-conv stem, an
    average pool, four layers of bottlenecks (the first at stride 1, the
    others at stride 2 in their first block), then the attention pool."""

    def __init__(self, arch: ClipArchitecture):
        super().__init__()
        w = arch.vision_width
        self.conv1 = ConvBN(w // 2, 3, 3)
        self.conv2 = ConvBN(w // 2, w // 2, 3)
        self.conv3 = ConvBN(w, w // 2, 3)
        cin = w
        for li, n_blocks in enumerate(arch.vision_layers):
            planes = w * 2**li
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(cin, planes, stride if bi == 0 else 1))
                cin = planes * 4
            self.add_module(f"layer{li + 1}", nn.ModuleList(blocks))
        self.layers = len(arch.vision_layers)
        self.attnpool = AttentionPool(arch.image_resolution // 32, w * 32,
                                      arch.embed_dim, arch.vision_heads)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC [B,R,R,3] in the compute dtype → [B, embed_dim]."""
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x, stride=2, padding=1))
        x = F.relu(self.conv2(x, padding=1))
        x = F.relu(self.conv3(x, padding=1))
        x = avg_pool(x, 2)
        for li in range(self.layers):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x)
        return self.attnpool(x)


def causal_mask(n: int, device=None) -> torch.Tensor:
    return torch.triu(
        torch.full((n, n), float("-inf"), dtype=torch.float32, device=device),
        diagonal=1,
    )


def prompt_tower_dtype() -> torch.dtype:
    """Compute dtype of the differentiated prompt tower (CoOp/CoCoOp train
    and eval text encodes): ``CLIP_GP_TPU_TORCH_PROMPT_TOWER_DTYPE`` is
    ``float32`` (the default, the reference's fp32 tower) or
    ``bf16``/``bfloat16`` (bf16 products with fp32 LN, softmax and
    gradients, and fp32 master parameters), as the JAX package's
    ``CLIP_GP_TPU_PROMPT_TOWER_DTYPE``."""
    v = os.environ.get("CLIP_GP_TPU_TORCH_PROMPT_TOWER_DTYPE", "float32").lower()
    return torch.bfloat16 if v in ("bf16", "bfloat16") else torch.float32


class CLIP(nn.Module):
    """Both towers plus the text embeddings and logit scale. Parameter names
    follow the JAX pytree (``visual.transformer.blocks.<i>.attn.w_qkv`` is
    layer i of ``visual/transformer/blocks/attn/w_qkv``)."""

    def __init__(self, arch: ClipArchitecture):
        super().__init__()
        self.arch = arch
        tw = arch.transformer_width
        self.visual = VisionTransformer(arch) if arch.is_vit else ModifiedResNet(arch)
        self.token_embedding = _param(arch.vocab_size, tw)
        self.pos_embed = _param(arch.context_length, tw)
        self.transformer = Transformer(tw, arch.transformer_layers,
                                       arch.transformer_heads)
        self.ln_final = LayerNorm(tw)
        self.text_projection = _param(tw, arch.embed_dim)
        self.logit_scale = _param(())

    def encode_image(self, images: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """images: NHWC [B,R,R,3] float — returns fp32 [B, embed_dim]."""
        return self.visual(images.to(compute_dtype)).float()

    def encode_image_all_layers(self, images: torch.Tensor,
                                compute_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
        """The projected class token after every block, the ViT debug mode
        (ref: clip/model.py:225-274, ``all_layer_outputs=True``): ln_post and
        the projection applied after each block → fp32 [layers, B, embed_dim]."""
        if not self.arch.is_vit:
            raise ValueError("all-layer outputs are defined for the ViT tower")
        visual = self.visual
        x = visual.stem(images.to(compute_dtype))
        outs = []
        for block in visual.transformer.blocks:
            x = block(x)
            outs.append(visual.head(x).float())
        return torch.stack(outs)

    def text_features_from_embeddings(
        self, token_embeds: torch.Tensor, eot_index: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Text transformer over token embeddings [B,L,W], pooled at
        ``eot_index`` [B] (ref: utils/trainer.py:178-194). Differentiable
        in ``token_embeds`` and in any tower weight that requires grad."""
        x = token_embeds.to(compute_dtype)
        n = x.shape[1]
        # slice to the (possibly trimmed) sequence length; the causal mask
        # makes the pooled features exact either way
        x = x + self.pos_embed[:n].to(x.dtype)
        x = self.transformer(x.contiguous(), causal_mask(n, x.device))
        x = layer_norm(self.ln_final, x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_index]
        return (pooled @ self.text_projection.to(pooled.dtype)).float()

    def encode_text(self, tokens: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """tokens: int [B, context_length] — returns fp32 [B, embed_dim]
        (ref: clip/model.py:378-391)."""
        tokens = tokens.long()
        embeds = self.token_embedding[tokens]
        eot_index = tokens.argmax(dim=-1)  # EOT has the highest token id
        return self.text_features_from_embeddings(embeds, eot_index,
                                                  compute_dtype)


def clip_forward(model: CLIP, images: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive logits (logits_per_image [B_img, B_txt], its transpose)
    (ref: clip/model.py:408-422)."""
    img = model.encode_image(images, compute_dtype)
    txt = model.encode_text(tokens, compute_dtype)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    logits_per_image = model.logit_scale.exp() * img @ txt.T
    return logits_per_image, logits_per_image.T
