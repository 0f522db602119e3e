"""Image preprocessing, split host/device.

Host side (this module, PIL + numpy): decode, crop/resize/flip/rotate/jitter —
producing uint8 HWC arrays. Device side (``device_preprocess``): uint8→float
conversion and CLIP mean/std normalization on the tensor's device. Shipping
uint8 to the device quarters host→device transfer volume versus the
reference's host-side float normalize (ref: utils/transforms.py).

PIL is imported inside the host transforms only, so the device half (and
every module that imports it) works on a host without Pillow.

Pipeline parity (ref: utils/transforms.py:20-97): train transforms are chosen
by config list (random_resized_crop scale 0.08–1, random_crop, random_flip,
random_rotation ±15°, color_jitter 0.4/0.4/0.4/0.1); test is shortest-side
resize + center crop. Randomness uses python ``random`` so the global run
seed governs augmentation like the reference.
"""

from __future__ import annotations

import math
import random
from functools import partial
from typing import Callable, List, Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _interp(mode: str):
    from PIL import Image

    return {
        "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC,
        "nearest": Image.NEAREST,
    }.get(mode, Image.BILINEAR)


def sample_rrc_box(
    width: int,
    height: int,
    scale=(0.08, 1.0),
    ratio=(3 / 4, 4 / 3),
    rng=random,
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop window (x, y, w, h). Shared by the PIL
    and native decode paths so both consume the identical RNG stream."""
    area = width * height
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            x = rng.randint(0, width - w)
            y = rng.randint(0, height - h)
            return x, y, w, h
    # fallback: center crop at the clamped aspect ratio
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    x = (width - w) // 2
    y = (height - h) // 2
    return x, y, w, h


def random_resized_crop(
    img: Image.Image,
    size: Tuple[int, int],
    scale=(0.08, 1.0),
    ratio=(3 / 4, 4 / 3),
    interpolation=None,
    rng=random,
) -> Image.Image:
    if interpolation is None:
        interpolation = _interp("bicubic")
    width, height = img.size
    x, y, w, h = sample_rrc_box(width, height, scale, ratio, rng)
    # torchvision crops FIRST, then resizes: the resample filter clamps at
    # the window edge. PIL's one-pass resize(box=) instead lets the taps
    # read neighboring full-image pixels, shifting window-border outputs by
    # up to ~10 gray levels (pinned by the executed-reference golden,
    # tests/test_reference_executed_transforms.py).
    # size is (h, w) like every transform here; PIL resize wants (w, h)
    return img.crop((x, y, x + w, y + h)).resize((size[1], size[0]), interpolation)


def center_crop(img: Image.Image, size: Tuple[int, int]) -> Image.Image:
    width, height = img.size
    th, tw = size
    # torchvision zero-pads undersized inputs floor-half on the left/top
    # (executed F.center_crop semantics); int(round(...)) would put the
    # extra row/column on the other side for odd deficits. PIL's
    # out-of-bounds crop fills zeros, so one crop call does both cases.
    x = -((tw - width) // 2) if tw > width else int(round((width - tw) / 2.0))
    y = -((th - height) // 2) if th > height else int(round((height - th) / 2.0))
    return img.crop((x, y, x + tw, y + th))


def resize_shortest(img: Image.Image, target: int, interpolation) -> Image.Image:
    width, height = img.size
    short, long = (width, height) if width <= height else (height, width)
    if short == target:
        return img
    new_short = target
    # torchvision's executed _compute_resized_output_size TRUNCATES the long
    # side (int(size * long / short)), it does not round — int(round(...))
    # shifted the resize (and the center crop behind it) by one pixel for
    # roughly half of all aspect ratios on every eval image
    new_long = int(target * long / short)
    nw, nh = (new_short, new_long) if width <= height else (new_long, new_short)
    return img.resize((nw, nh), interpolation)


def random_crop(img: Image.Image, size: Tuple[int, int], rng=random) -> Image.Image:
    width, height = img.size
    th, tw = size
    if width == tw and height == th:
        return img
    x = rng.randint(0, max(0, width - tw))
    y = rng.randint(0, max(0, height - th))
    return img.crop((x, y, x + tw, y + th))


def color_jitter(
    img: Image.Image,
    brightness=0.4,
    contrast=0.4,
    saturation=0.4,
    hue=0.1,
    rng=random,
) -> Image.Image:
    from PIL import ImageEnhance

    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        fc = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(fc))
    if saturation > 0:
        fs = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(fs))
    if hue > 0:
        h = rng.uniform(-hue, hue)

        def shift_hue(im, h=h):
            from PIL import Image

            hsv = np.array(im.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
            return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

        ops.append(shift_hue)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def build_transform(config, is_train: bool = False) -> Callable[[Image.Image], np.ndarray]:
    """PIL image → uint8 HWC array of ``config.input.size``."""
    size = tuple(config.input.size)
    interpolation = _interp(config.input.interpolation)

    if is_train:
        names: List[str] = list(config.input.transforms)

        def train_tfm(img: Image.Image, rng=random) -> np.ndarray:
            # rng is a per-item Random from the loader so augmentation is
            # deterministic under the run seed regardless of worker-thread
            # interleaving
            from PIL import Image

            applied_spatial = False
            for name in names:
                if name == "random_resized_crop":
                    img = random_resized_crop(
                        img, size, interpolation=interpolation, rng=rng
                    )
                    applied_spatial = True
                elif name == "random_crop":
                    img = random_crop(img, size, rng=rng)
                    applied_spatial = True
                elif name == "random_flip":
                    if rng.random() < 0.5:
                        img = img.transpose(Image.FLIP_LEFT_RIGHT)
                elif name == "random_rotation":
                    # torchvision RandomRotation's executed default
                    # interpolation is NEAREST, not bilinear
                    img = img.rotate(rng.uniform(-15, 15), resample=Image.NEAREST)
                elif name == "color_jitter":
                    img = color_jitter(img, rng=rng)
                # "normalize" happens on device
            if not applied_spatial or img.size != (size[1], size[0]):
                img = resize_shortest(img, size[0], interpolation)
                img = center_crop(img, size)
            return np.asarray(img.convert("RGB"), dtype=np.uint8)

        spatial_names = [n for n in names if n != "normalize"]
        if (
            size[0] == size[1]
            and config.input.interpolation == "bicubic"
            and spatial_names in (
                ["random_resized_crop"],
                ["random_resized_crop", "random_flip"],
            )
        ):
            # eligible for the native fused decode→crop→resize(→flip) path
            # (data/pipeline.py); the window/flip RNG draws stay in Python
            # via sample_rrc_box so PIL and native consume the same stream
            train_tfm.native_rrc = {
                "target": size[0],
                "flip": "random_flip" in names,
            }
        train_tfm.uses_rng = True
        return train_tfm

    def test_tfm(img: Image.Image, rng=None) -> np.ndarray:
        img = resize_shortest(img, size[0], interpolation)
        img = center_crop(img, size)
        return np.asarray(img.convert("RGB"), dtype=np.uint8)

    # deterministic: the loader must NOT burn per-item seeds from the
    # run-seeded stream for this transform — in the reference, evaluation
    # never touches python `random`, so an eval pass (EVAL_FREQ,
    # best_val tracking, predict) must not shift later training draws
    test_tfm.uses_rng = False
    if size[0] == size[1] and config.input.interpolation == "bicubic":
        # deterministic square resize+crop: eligible for the native fused
        # JPEG decode path (see data/pipeline.py)
        test_tfm.native_target = size[0]
    return test_tfm


def device_preprocess(images_u8, mean=CLIP_MEAN, std=CLIP_STD):
    """uint8 NHWC tensor → normalized float32 NHWC on the same device."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def preprocess_fn(config):
    return partial(
        device_preprocess,
        mean=tuple(config.input.pixel_mean),
        std=tuple(config.input.pixel_std),
    )
