"""Native host-pipeline components (C++ via ctypes), the JAX package's
``native/`` with its source copied verbatim.

``fast_decode``: fused JPEG decode → bicubic resize → center crop (and the
train path's decode → RandomResizedCrop window → resize → flip) using
libjpeg(-turbo)'s DCT-domain scaling. Compiled on first use into
``build/native/``; every caller falls back to the PIL path when the
toolchain or libjpeg is unavailable. ``data/pipeline.py`` takes it with
``CLIP_GP_TPU_TORCH_NATIVE_DECODE=1``.
"""

from clip_gp_tpu_torch.native.loader import (  # noqa: F401
    decode_resize_crop,
    decode_rrc,
    jpeg_dims,
    native_available,
    unavailable_reason,
)
