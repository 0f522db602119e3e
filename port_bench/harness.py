"""What every cell shares: finding a cell's files by name, the run's
environment, the card, the window's clock, the profiler's reading and the
result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<kind>.py``: its ``run`` and the ``control`` readings that the
limits are set from) and the cell's limits live in ``limits/<cell>.json``. A per-layer metric is ``metrics/<metric>.py``, whose
``read(record)`` returns the metric or None where the run has nothing for
it to read. New cells, mixes and metrics are new files.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "clip_gp_tpu")


class BenchmarkError(RuntimeError):
    """A fault of the benchmark itself (a file it needs, or a part of the
    program it reads, is missing): the run prints its message and no
    result, and is not a reading of ``correct``."""


@dataclasses.dataclass
class Context:
    """One run of one cell: what its files say and what the command line
    asks for. ``work`` is a scratch directory under ``TMPDIR``."""

    cell: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: Any
    work: Path
    t_start: float


def context(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            config: Optional[Dict] = None, traffic: Optional[Dict] = None) -> Context:
    """The run's context from the cell's files; ``config`` and ``traffic``
    are merged over the files' (the harness's tests run a cell at a small
    size on the CPU with them)."""
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if cell not in cells:
        raise BenchmarkError(f"unknown workload {cell!r}; cells: {sorted(cells)}")
    wl = cells[cell]
    if device.type == "cpu":
        os.environ["CLIP_GP_TPU_TORCH_FORCE_CPU"] = "1"
    return Context(
        cell=cell, config={**load_json("configs", wl["config"]), **(config or {})},
        traffic={**load_json("traffic", wl["traffic"]), **(traffic or {})},
        limits=load_json("limits", cell), chips=int(wl["chips"]), seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        work=Path(tempfile.mkdtemp(prefix="port_bench-")), t_start=t_start)


@contextlib.contextmanager
def patched(target, name: str, value):
    """``target.name`` set to ``value`` for the block (a fault planted in
    the program, in the readings of ``control.py`` and the tests)."""
    old = getattr(target, name)
    setattr(target, name, value)
    try:
        yield
    finally:
        setattr(target, name, old)


def load_json(kind: str, name: str) -> Dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise BenchmarkError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by file path (metric files carry dots in
    their names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(f"port_bench_file_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str) -> ModuleType:
    return load_module(HERE / "drivers" / f"{kind}.py")


def reader(metric: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{metric}.py")


def cell_metrics(bench: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    def applies(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and ("workloads" in m or m["moves"] in names)]
    return e2e, layer


def set_environment() -> None:
    """Caches at fixed paths inside the checkout; random CLIP weights, which
    the port draws from the run's seed; no JAX through a library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    for name in ("CLIP_GP_TPU_TORCH_FORCE_CPU", "CLIP_GP_TPU_TORCH_FEATURE_CACHE",
                 "CLIP_GP_TPU_TORCH_NATIVE_DECODE", "CLIP_GP_TPU_TORCH_PROFILE_DIR"):
        os.environ.pop(name, None)


def check_architecture(cfg: Dict) -> None:
    """The configuration file's widths are those of the port's architecture
    table entry that the program runs (``MODEL.BACKBONE_NAME``)."""
    import dataclasses

    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    arch = dataclasses.asdict(ARCHITECTURES[cfg["backbone"]])
    for key, value in arch.items():
        if key == "name":
            continue
        mine = cfg.get(key)
        if (list(value) if isinstance(value, tuple) else value) != mine:
            raise ValueError(f"{cfg['backbone']}: {key} is {value!r} in the port, {mine!r} here")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def seed_ints(seed: int, tag: int, n: int, high: int = 2 ** 31 - 1) -> List[int]:
    """``n`` integers in [1, high) drawn from (seed, tag)."""
    import numpy as np

    ss = np.random.SeedSequence([int(seed) % 2 ** 64, tag])
    return [int(v) % (high - 1) + 1 for v in ss.generate_state(n, dtype=np.uint64)]


# ----------------------------------------------------------------------
# the profiler
# ----------------------------------------------------------------------

class Trace:
    """A ``torch.profiler`` session over one stretch of the window, reduced
    to device intervals, host ops and the benchmark's own markers."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.summary: Optional[Dict] = None

    def __enter__(self) -> "Trace":
        self.prof.start()
        self._range = mark_begin("port_bench.window")
        return self

    def __exit__(self, *exc) -> None:
        mark_end(self._range)
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.summary = reduce_events(_events(self.prof))


def mark_begin(name: str):
    import torch

    return torch.ops.profiler._record_function_enter_new(name, None)


def mark_end(handle) -> None:
    import torch

    torch.ops.profiler._record_function_exit._RecordFunction(handle)


def mark(name: str) -> None:
    mark_end(mark_begin(name))


def _events(prof) -> List[Tuple[bool, str, int, int]]:
    """(on the device, name, start ns, end ns) of every event."""
    from torch.autograd import DeviceType

    out = []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            out.append((e.device_type() != DeviceType.CPU, e.name(), int(start), int(start + dur)))
        return out
    for e in prof.events():
        out.append((e.device_type != DeviceType.CPU, e.name,
                    int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return out


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def reduce_events(events: List[Tuple[bool, str, int, int]]) -> Dict:
    """Device busy time and the window, the device ops by time, the idle
    gaps named by the innermost host op (else benchmark span) under them,
    the benchmark's markers, and every device op as (name, start ns)."""
    window = [(s, e) for dev, n, s, e in events if not dev and n == "port_bench.window"]
    if not window:
        raise RuntimeError("the trace holds no port_bench.window range")
    w0, w1 = window[0]
    device = [(n, s, e) for dev, n, s, e in events
              if dev and not n.startswith("port_bench") and e > s and s < w1 and e > w0]
    busy = _merge([(max(s, w0), min(e, w1)) for _, s, e in device])
    by_name: Dict[str, float] = {}
    for n, s, e in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    gaps, cursor = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [(n, s, e) for dev, n, s, e in events if not dev and n != "port_bench.window"]
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        under = [(e - s, n) for n, s, e in host if s <= mid <= e]
        ops = [u for u in under if not u[1].startswith("port_bench")]
        label = min(ops or under or [(0, "host work outside torch ops")])[1]
        named.append([label, (g1 - g0) / 1e9])
    markers: Dict[str, List[int]] = {}
    for n, s, _ in host:
        if n.startswith("port_bench."):
            markers.setdefault(n, []).append(s)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_ops": sorted(([n[:160], t] for n, t in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": named,
        "markers": {k: sorted(v) for k, v in markers.items()},
        "device": [(n, s, e) for n, s, e in device],
    }


def kernel_starts(summary: Dict) -> List[int]:
    """Start times of the device's kernels (copies and fills left out)."""
    return [s for n, s, _ in summary["device"]
            if not n.startswith(("Memcpy", "Memset", "memcpy", "memset"))]
