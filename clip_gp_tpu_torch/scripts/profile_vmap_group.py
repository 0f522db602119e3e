"""Profile one realistic trial-batched group (the unit the sweep runner
schedules) and print the per-phase wall-clock breakdown, the JAX package's
``scripts/profile_vmap_group.py`` on the port: where group time goes.

One group is five seeds of the flagship Adapter+GP trial through
``parallel/trial_vmap.py``'s ``run_seed_vmapped_adapter`` (one union encode
through K1/K2, then every trial's GP step at once), on a Synthetic JPEG
tree at 224 px. The phases are ``runtime/profiling.py``'s ``vmap.*``
timers, each ended by a CUDA synchronize, and ``TOTAL``. The JPEGs decode
natively where the C++ decoder builds (``CLIP_GP_TPU_TORCH_NATIVE_DECODE``
defaults to 1 here, as the JAX script sets its own), else through Pillow.

Usage: python -m clip_gp_tpu_torch.scripts.profile_vmap_group [--shots 4]
       [--classes 100] [--images-per-class 42] [--epochs 100] [--repeat 1]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from clip_gp_tpu_torch.scripts._common import bench_context, gp_config

SEEDS = [1, 2, 3, 4, 5]


def run(shots: int = 4, classes: int = 100, images_per_class: int = 42,
        epochs: int = 100, repeat: int = 1, backbone: str = "ViT-B/16",
        image_size: int = 224, workers=None) -> dict:
    """``{"runs": [{phase: seconds, ..., "TOTAL": seconds}], ...}``, one
    entry per repeat."""
    from clip_gp_tpu_torch.core.device import device_label
    from clip_gp_tpu_torch.data.datasets.synthetic import (
        generate_synthetic_imagefolder,
    )
    from clip_gp_tpu_torch.parallel.trial_vmap import run_seed_vmapped_adapter
    from clip_gp_tpu_torch.runtime.profiling import phase_report, reset_phases

    runs = []
    with bench_context("profile_vmap_", CLIP_GP_TPU_TORCH_NATIVE_DECODE="1") as tmp:
        generate_synthetic_imagefolder(
            tmp, num_classes=classes, images_per_class=images_per_class,
            image_size=image_size, seed=0, fmt="jpg",
        )
        c = gp_config(tmp, shots, backbone, image_size, epochs, workers)
        for r in range(repeat):
            reset_phases()
            t0 = time.time()
            run_seed_vmapped_adapter(c, SEEDS, None)
            total = time.time() - t0
            rep = {k: round(v["total_s"], 2) for k, v in phase_report().items()}
            rep["TOTAL"] = round(total, 2)
            print(f"=== run {r + 1}/{repeat} ===", file=sys.stderr)
            runs.append(rep)
    return {"runs": runs, "shots": shots, "classes": classes, "epochs": epochs,
            "seeds": len(SEEDS), "backbone": backbone, "device": device_label()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--images-per-class", type=int, default=42)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the group N times (the first pays set-up)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.shots, args.classes, args.images_per_class,
                         args.epochs, args.repeat)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
