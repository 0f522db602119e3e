"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data, model, warm-up), then the window of ``--seconds``, then the
check of what the window produced against the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced, ``breakdown``;
``checks`` comes last, each number compared with its limit, and the same
numbers end standard error. Exits non-zero without printing a result where
the card is missing, JAX was loaded, or the benchmark itself is at fault
(a file it needs, or a part of the program it reads, is missing).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench import harness

    harness.set_environment()
    import torch

    try:
        chips = {w["name"]: w["chips"] for w in harness.benchmark()["workloads"]}.get(args.workload)
        if chips is None:
            raise harness.BenchmarkError(f"unknown workload {args.workload!r}")
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found {found}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        ctx = harness.context(args.workload, args.seed, args.seconds, bool(args.trace),
                              device, T_START)
        return execute(ctx)
    except harness.BenchmarkError as e:
        print(f"benchmark error: {e}", file=sys.stderr)
        return 4


def execute(ctx) -> int:
    """Run the cell of ``ctx`` once and print its result line."""
    from port_bench import compare, harness
    import torch

    try:
        result = harness.driver(ctx.traffic["kind"]).run(ctx)
    except harness.BenchmarkError as e:
        print(f"benchmark error: {e}", file=sys.stderr)
        return 4
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)

    e2e, layer = harness.cell_metrics(harness.benchmark(), ctx.cell)
    metrics = {}
    if not ctx.trace:
        for m in e2e:
            value = result["setup_s"] if m["name"] == "setup_s" else result["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in layer:
            value = harness.reader(m["name"]).read(result["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    device = ctx.device
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": ctx.chips, "memory_peak_bytes": int(result["memory_peak_bytes"])}
    if device.type == "cuda":
        device_info["power"] = harness.power_limit()
    line = {"correct": compare.correct(result["checks"]),
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device_info}
    trace = result.get("trace")
    if ctx.trace and trace is not None:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checks"] = result["checks"]
    print(f"timing setup_s {result['setup_s']:.3f} window_s {result['window_s']:.3f} "
          f"check_s {result['check_s']:.3f}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
