"""Per-backbone feature-extraction throughput across batch sizes, the JAX
package's ``scripts/bench_backbones.py`` on the port.

Measures every real CLIP backbone (RN50/RN101/RN50x4/RN50x16/ViT-B/32/
ViT-B/16, random weights) at several batch sizes: uint8 images on the card
→ ``device_preprocess`` → ``encode_image`` with bf16 compute, as the JAX
script runs it. The ViT towers run K1/K2 in every block; the ModifiedResNet
towers run cuDNN convolutions in bf16 (their weights are cast to the input's
dtype) and a plain attention pool. One warm-up call, then ``TIMED_ITERS``
calls between two ``torch.cuda.synchronize()``. A cell that runs out of
device memory reads ``"ERR:OutOfMemoryError"``; any other error raises.

    python -m clip_gp_tpu_torch.scripts.bench_backbones [--backbones A,B] \\
        [--batches 128,256]

Prints one JSON object with an imgs/s table.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from clip_gp_tpu_torch.scripts._common import sync

DEFAULT_BACKBONES = ("ViT-B/16", "ViT-B/32", "RN50", "RN101", "RN50x4",
                     "RN50x16")
DEFAULT_BATCHES = (128, 256, 512)
TIMED_ITERS = 10
COMPUTE_DTYPE = torch.bfloat16


def measure(model, batch: int, timed_iters: int, device) -> float:
    """imgs/s of ``model.encode_image`` on ``batch`` random uint8 images at
    the tower's resolution, on ``device`` (the model's)."""
    from clip_gp_tpu_torch.data.transforms import device_preprocess

    rng = np.random.default_rng(0)
    res = int(model.arch.image_resolution)
    x = torch.from_numpy(
        rng.integers(0, 256, size=(batch, res, res, 3), dtype=np.uint8)
    ).to(device)

    def step():
        with torch.no_grad():
            return model.encode_image(device_preprocess(x), COMPUTE_DTYPE)

    step()  # warm-up
    sync(device)
    start = time.perf_counter()
    for _ in range(timed_iters):
        out = step()
    sync(device)
    elapsed = time.perf_counter() - start
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{model.arch.name} b={batch}: non-finite features")
    return batch * timed_iters / elapsed


def run(backbones=DEFAULT_BACKBONES, batches=DEFAULT_BATCHES,
        timed_iters: int = TIMED_ITERS, device=None) -> dict:
    from clip_gp_tpu_torch.core.device import device_label, resolve_device
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    device = resolve_device(device)
    batches = [int(b) for b in batches]
    table = {}
    for backbone in backbones:
        model = init_clip_params(ARCHITECTURES[backbone], 0, device)
        row = {}
        for batch in batches:
            try:
                rate = measure(model, batch, timed_iters, device)
            except torch.cuda.OutOfMemoryError as e:
                row[str(batch)] = f"ERR:{type(e).__name__}"
                print(f"# {backbone} b={batch}: {e}", file=sys.stderr)
                torch.cuda.empty_cache()
                continue
            row[str(batch)] = round(rate, 1)
            print(f"# {backbone:>9} b={batch:<4} {rate:,.0f} imgs/s",
                  file=sys.stderr)
        table[backbone] = row
        del model
    return {
        "metric": "feature_extract_imgs_per_sec_per_chip",
        "unit": "imgs/s",
        "dtype": str(COMPUTE_DTYPE).replace("torch.", ""),
        "device": device_label(device),
        "batches": batches,
        "table": table,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backbones", default=",".join(DEFAULT_BACKBONES))
    ap.add_argument("--batches", default=",".join(map(str, DEFAULT_BATCHES)))
    args = ap.parse_args(argv)
    backbones = [b.strip() for b in args.backbones.split(",") if b.strip()]
    batches = [int(b) for b in args.batches.split(",")]
    print(json.dumps(run(backbones, batches)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
