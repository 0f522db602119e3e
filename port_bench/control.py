"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size (not run by the benchmark's runs). Each
mix's driver says what they are (``drivers/<kind>.py``, ``control``):

- ``sound``: the program against the float64 reference, as a run checks it;
- ``control`` (unless ``--no-control``): the reference in the program's
  place in the precision below the configuration's (fp32 with TF32
  products and convolutions, where the configuration states fp32 with TF32
  off) against the float64 reference;
- with ``--faults``, each fault the cell can have, planted in the program
  or in the reference put in its place.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 [--no-control] [--faults]

Prints one JSON line per seed.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true", help="the sound readings alone")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    from port_bench import harness

    harness.set_environment()
    import torch

    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.context(args.workload, seed, 0.0, False, torch.device("cuda", 0), t0)
        try:
            readings = harness.driver(ctx.traffic["kind"]).control(
                ctx, lower=not args.no_control, faults=args.faults)
        finally:
            shutil.rmtree(ctx.work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
