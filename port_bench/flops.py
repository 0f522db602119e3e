"""The yardstick: the H100's published peaks and the operations and bytes
of the work a cell does, counted from shapes. A multiply-add counts two
operations; elementwise work, normalisations and softmax are left out.
A kernel's bytes are each input read once and each output written once.

Peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): a product with fp32
inputs counts against the TF32 tensor-core rate, whatever implements it,
so no implementation of fp32 work can read above 100%.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS = {"float32": 495e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def _block(tokens: int, width: int) -> int:
    """One pre-LN transformer block over one sequence: qkv, out-projection,
    the two MLP products (4x width) and attention's two products."""
    return 24 * tokens * width ** 2 + 4 * tokens ** 2 * width


def text_flops(cfg: Dict) -> int:
    """One prompt through the text tower (every token of the context), and
    the projection of the pooled token."""
    n, w = cfg["context_length"], cfg["transformer_width"]
    return cfg["transformer_layers"] * _block(n, w) + 2 * w * cfg["embed_dim"]


def vit_flops(cfg: Dict) -> int:
    """One image through the ViT tower."""
    ps, w = cfg["vision_patch_size"], cfg["vision_width"]
    patches = (cfg["image_resolution"] // ps) ** 2
    return (2 * patches * 3 * ps * ps * w + cfg["vision_layers"] * _block(patches + 1, w)
            + 2 * w * cfg["embed_dim"])


def _conv(hw: int, cin: int, cout: int, k: int) -> int:
    return 2 * hw * hw * cin * cout * k * k


def resnet_flops(cfg: Dict) -> int:
    """One image through the ModifiedResNet tower: every convolution at its
    output resolution, and the attention pool's query of one token."""
    w, r = cfg["vision_width"], cfg["image_resolution"]
    hw = r // 2
    total = _conv(hw, 3, w // 2, 3) + _conv(hw, w // 2, w // 2, 3) + _conv(hw, w // 2, w, 3)
    hw //= 2
    cin = w
    for li, n_blocks in enumerate(cfg["vision_layers"]):
        planes = w * 2 ** li
        for bi in range(n_blocks):
            stride = 2 if li > 0 and bi == 0 else 1
            out = hw // stride
            total += _conv(hw, cin, planes, 1) + _conv(hw, planes, planes, 3)
            total += _conv(out, planes, planes * 4, 1)
            if stride > 1 or cin != planes * 4:
                total += _conv(out, cin, planes * 4, 1)
            cin, hw = planes * 4, out
    e, tokens = w * 32, hw * hw + 1
    return total + 2 * e * e + 2 * 2 * tokens * e * e + 4 * tokens * e + 2 * e * cfg["embed_dim"]


def image_flops(cfg: Dict) -> int:
    return vit_flops(cfg) if cfg["vision_patch_size"] else resnet_flops(cfg)


def gp_forward_flops(t: int, b: int, s: int, k: int, m: int, d: int, red: int) -> int:
    """The Adapter + GP loss of one batch for t trials: the projection,
    the GP's Gram matrices over M+1 inducing points, the prototypes and the
    MC logits."""
    p = m + 1
    return (2 * t * b * d * d + 2 * t * k * (p * p + p * m + m * m) * red
            + 2 * t * s * k * m * d + 2 * t * s * b * k * d)


def gp_step_flops(t: int, b: int, s: int, k: int, m: int, d: int, red: int) -> int:
    """Forward and backward: the backward's products cost twice the forward's."""
    return 3 * gp_forward_flops(t, b, s, k, m, d, red)


def gp_eval_flops(t: int, n: int, s: int, k: int, m: int, d: int, red: int) -> int:
    """Eval logits of t trials on n shared features."""
    p = m + 1
    return (2 * t * n * d * d + 2 * t * k * (p * p + p * m + m * m) * red
            + 2 * t * s * k * m * d + 2 * t * n * k * d)


def ln_attention_block(b: int, n: int, d: int, bytes_per: int = 4) -> Tuple[int, int]:
    """(operations, bytes) of one K1 call: LN, qkv, attention, out-projection
    and residual over [b, n, d]."""
    ops = 8 * b * n * d * d + 4 * b * n * n * d
    return ops, bytes_per * (2 * b * n * d + 4 * d * d + 4 * d + 2 * d)


def ln_mlp_block(b: int, n: int, d: int, bytes_per: int = 4) -> Tuple[int, int]:
    """(operations, bytes) of one K2 call: LN, the 4x MLP and residual."""
    ops = 16 * b * n * d * d
    return ops, bytes_per * (2 * b * n * d + 8 * d * d + 5 * d + 2 * d)


def bound_seconds(ops: float, nbytes: float, dtype: str = "float32") -> float:
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
