"""End-to-end ViT encode throughput: the bf16 tower (K1/K2) against the
opt-in int8 tower (K5/K6), the JAX package's
``scripts/bench_int8_encode.py`` on the port.

The int8 tower's weights are quantized once (``quantized.quantize_visual``)
before any timed call. Each tower: one warm-up call, then ``WINDOWS``
windows of ``TIMED_ITERS`` calls, each between two
``torch.cuda.synchronize()``; the best window counts. The report also holds
the least cosine similarity between the two towers' features of the last
batch (``<tower>_min_cosine``), which says the int8 tower still computes
the bf16 tower's features.

    python -m clip_gp_tpu_torch.scripts.bench_int8_encode
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from clip_gp_tpu_torch.scripts._common import sync

BATCH = 256
TIMED_ITERS = 20
WINDOWS = 3
ARCHS = ("ViT-B/16", "ViT-B/32")


def measure(encode, x, batch: int, timed_iters: int, windows: int, device):
    """(imgs/s of the best window, the last features)."""
    out = encode(x)
    sync(device)
    best = float("inf")
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(timed_iters):
            out = encode(x)
        sync(device)
        best = min(best, time.perf_counter() - start)
    return batch * timed_iters / best, out


def run(batch: int = BATCH, timed_iters: int = TIMED_ITERS,
        windows: int = WINDOWS, archs=ARCHS, device=None) -> dict:
    from clip_gp_tpu_torch.core.device import device_label, resolve_device
    from clip_gp_tpu_torch.data.transforms import device_preprocess
    from clip_gp_tpu_torch.models import quantized
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    device = resolve_device(device)
    out = {"batch": batch, "device": device_label(device)}
    for name in archs:
        arch = ARCHITECTURES[name]
        model = init_clip_params(arch, 0, device)
        res = int(arch.image_resolution)
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, size=(batch, res, res, 3), dtype=np.uint8)).to(device)
        qvisual = quantized.quantize_visual(model, arch)

        def bf16(x):
            with torch.no_grad():
                return model.encode_image(device_preprocess(x), torch.bfloat16)

        def q8(x):
            return quantized.encode_image_q8(qvisual, arch, device_preprocess(x))

        key = name.replace("/", "").replace("-", "").lower()
        rate_bf16, f_bf16 = measure(bf16, x, batch, timed_iters, windows, device)
        rate_q8, f_q8 = measure(q8, x, batch, timed_iters, windows, device)
        out[f"{key}_bf16_imgs_per_sec"] = round(rate_bf16, 1)
        out[f"{key}_int8_imgs_per_sec"] = round(rate_q8, 1)
        out[f"{key}_speedup"] = round(rate_q8 / rate_bf16, 2)
        out[f"{key}_min_cosine"] = float(
            torch.nn.functional.cosine_similarity(f_q8, f_bf16, dim=-1).min())
        del model, qvisual
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
