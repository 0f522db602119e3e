"""CLIP encoders as PyTorch modules (ref: clip/model.py).

The ViT image tower and the causal text tower, held against the JAX package's
``clip_gp_tpu/models/clip_model.py``: the same architectures, parameter names
and layouts (right-multiply ``w_qkv [D, 3D]`` packing, NHWC images at the
public functions), and the same numerics (LayerNorm and softmax in fp32
whatever the compute dtype). Every residual block runs K1 then K2
(``ops/flash_attention.py``): hand-written CUDA kernels on a GPU, their plain
PyTorch versions on the CPU. The text tower is differentiable: the prompt
learners (CoOp, CoCoOp) backpropagate through it to their context vectors,
and each block's backward runs K4 then K3.

Not ported yet: the ModifiedResNet tower (RN50…RN50x16) and
``encode_image_all_layers``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

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
    """Patch-embedding conv weight, stored OIHW (the JAX params hold HWIO)."""

    def __init__(self, cout: int, cin: int, k: int):
        super().__init__()
        self.w = _param(cout, cin, k, k)


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

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC [B,R,R,3] in the compute dtype → [B, embed_dim]."""
        dt = images.dtype
        x = F.conv2d(images.permute(0, 3, 1, 2), self.conv1.w.to(dt),
                     stride=self.patch_size)  # [B, W, grid, grid]
        b, w = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # [B, grid², W], row-major patches
        cls = self.class_embed.to(dt).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = layer_norm(self.ln_pre, x)
        x = self.transformer(x)
        x = layer_norm(self.ln_post, x[:, 0])
        return x @ self.proj.to(dt)


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
        if not arch.is_vit:
            raise NotImplementedError(
                f"{arch.name}: the ModifiedResNet image tower is not ported yet"
            )
        self.arch = arch
        tw = arch.transformer_width
        self.visual = VisionTransformer(arch)
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
