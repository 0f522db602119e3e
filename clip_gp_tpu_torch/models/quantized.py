"""Opt-in int8 inference path for the ViT image tower (serving mode), the
counterpart of the JAX package's ``models/quantized.py``.

The encoders are frozen in every CLIP-GP method, so inference-time
quantization only perturbs the extracted features. The recipe:

- **weights**: symmetric per-output-channel int8, quantized once up front
  (``quantize_weight``, ``quantize_visual``);
- **activations**: symmetric per-row dynamic int8 (``ops/int8_block.py``
  ``quantize_rows``), no calibration data;
- **everything else** (patch conv, embeds, LayerNorm, softmax, GELU,
  residuals, the attention core) stays in the compute dtype or fp32.

Only the four projections of each block (qkv, out, c_fc, c_proj) run as
int8×int8→int32 products. The default tower (``use_fused=None`` or True) runs
every block as K5 then K6 (``ops/int8_block.py``): the hand-written CUDA
kernels on the card, their plain versions on the CPU. It quantizes the LN and
GELU outputs in fp32 and the attention output per head, like the JAX fused
Pallas tower (its feature-cache label is ``int8``). ``use_fused=False`` is the
JAX package's unfused ``int8xla`` tower (quantize after the bf16 cast, the
merged attention row), plain PyTorch through the exact int8 product. The two
towers are not bit-identical.

This is not the default: ``MODEL.INT8_INFERENCE`` (``--int8`` of the predict
entry) turns it on for the image encodes of a trainer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clip_gp_tpu_torch.models.clip_model import ClipArchitecture, multi_head_attention
from clip_gp_tpu_torch.ops import int8_block
from clip_gp_tpu_torch.ops.flash_attention import layer_norm_f32
from clip_gp_tpu_torch.ops.int8_block import QUANT_EPS, int8_matmul, quantize_rows

Params = Dict[str, Any]


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of ``w [..., I, O]``:
    one scale per output channel, over the input (contraction) axis; leading
    axes are kept. Returns {"q": int8 [..., I, O], "scale": fp32 [..., O]}."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=-2, keepdim=True)
    # a tensor divisor, as in quantize_rows: IEEE division on the card too
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), QUANT_EPS)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "scale": scale[..., 0, :].contiguous()}


def int8_linear(x: torch.Tensor, wq: Dict[str, torch.Tensor],
                b: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ w + b`` through the exact int8 product with an fp32 rescale;
    x [..., I] float, wq {"q": int8 [I, O], "scale": fp32 [O]}."""
    xq, x_scale = quantize_rows(x)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq["q"])
    y = acc.reshape(*x.shape[:-1], -1).float() * x_scale * wq["scale"]
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


def _with_k_major(wq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``wq`` with "qt": its int8 weight transposed to [O, I], contiguous,
    the K-major layout the int8 GEMM of the K5/K6 kernels reads."""
    return {**wq, "qt": wq["q"].t().contiguous()}


def quantize_visual(model, arch: ClipArchitecture) -> Params:
    """Quantize the ViT tower's block products once, up front.

    Returns {"visual": the model's ``VisionTransformer`` (its stem and
    epilogue are shared), "blocks": one dict per layer shaped like the JAX
    package's block params, with each product weight replaced by
    {"q", "scale", "qt"}}: "q" and "scale" as the JAX package's, "qt" the
    K-major copy of "q" that the K5/K6 kernels read, made here once rather
    than in every call."""
    if not arch.is_vit:
        raise NotImplementedError(
            "the int8 inference path covers the ViT towers only, not "
            f"{arch.name}"
        )
    visual = model.visual
    blocks = []
    with torch.no_grad():
        for blk in visual.transformer.blocks:
            a, m = blk.attn, blk.mlp
            blocks.append({
                "ln_1": {"scale": blk.ln_1.scale, "bias": blk.ln_1.bias},
                "ln_2": {"scale": blk.ln_2.scale, "bias": blk.ln_2.bias},
                "attn": {
                    "w_qkv": _with_k_major(quantize_weight(a.w_qkv)),
                    "b_qkv": a.b_qkv,
                    "w_out": _with_k_major(quantize_weight(a.w_out)),
                    "b_out": a.b_out,
                },
                "mlp": {
                    "c_fc": {"w": _with_k_major(quantize_weight(m.c_fc.w)),
                             "b": m.c_fc.b},
                    "c_proj": {"w": _with_k_major(quantize_weight(m.c_proj.w)),
                               "b": m.c_proj.b},
                },
            })
    return {"visual": visual, "blocks": blocks}


def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    return layer_norm_f32(x, p["scale"], p["bias"]).to(x.dtype)


def _q8_attention_block(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The JAX package's unfused int8 block: int8 products through
    ``int8_linear`` with their outputs in the compute dtype, the plain
    attention core, fp32 LayerNorm and softmax."""
    a, mlp = p["attn"], p["mlp"]
    h = _layer_norm(p["ln_1"], x)
    qkv = int8_linear(h, a["w_qkv"], a["b_qkv"], out_dtype=x.dtype)
    q, k, v = qkv.split(x.shape[-1], dim=-1)
    attn = multi_head_attention(q, k, v, num_heads)
    x = x + int8_linear(attn, a["w_out"], a["b_out"], out_dtype=x.dtype)
    h = int8_linear(_layer_norm(p["ln_2"], x), mlp["c_fc"]["w"], mlp["c_fc"]["b"],
                    out_dtype=x.dtype)
    h = h * torch.sigmoid(1.702 * h)
    return x + int8_linear(h, mlp["c_proj"]["w"], mlp["c_proj"]["b"],
                           out_dtype=x.dtype)


def _q8_fused_block(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K5 then K6 (``ops/int8_block.py``): the activations quantize right
    after the fp32 LN and GELU, the attention output per head."""
    a, mlp = p["attn"], p["mlp"]
    fc, proj = mlp["c_fc"]["w"], mlp["c_proj"]["w"]
    x = int8_block.q8_ln_attention_block(
        x, p["ln_1"]["scale"], p["ln_1"]["bias"],
        a["w_qkv"]["q"], a["w_qkv"]["scale"], a["b_qkv"],
        a["w_out"]["q"], a["w_out"]["scale"], a["b_out"], num_heads, None,
        a["w_qkv"]["qt"], a["w_out"]["qt"],
    )
    return int8_block.q8_ln_mlp(
        x, p["ln_2"]["scale"], p["ln_2"]["bias"],
        fc["q"], fc["scale"], mlp["c_fc"]["b"],
        proj["q"], proj["scale"], mlp["c_proj"]["b"], fc["qt"], proj["qt"],
    )


def encode_image_q8(qvisual: Params, arch: ClipArchitecture,
                    images: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    use_fused: Optional[bool] = None) -> torch.Tensor:
    """ViT image encode with int8 block products: images NHWC [B,R,R,3]
    float → fp32 [B, embed_dim]. ``qvisual`` comes from ``quantize_visual``;
    the stem and epilogue are the shared ``VisionTransformer``'s, in the
    compute dtype. ``use_fused=None`` means fused (K5/K6) on every device."""
    if not arch.is_vit:
        raise NotImplementedError(f"{arch.name}: the int8 path covers ViT only")
    block = _q8_attention_block if use_fused is False else _q8_fused_block
    with torch.no_grad():
        x = qvisual["visual"](images.to(compute_dtype), block_fn=block,
                              block_params=qvisual["blocks"])
    return x.float()
