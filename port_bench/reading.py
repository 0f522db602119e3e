"""What the per-layer metric readers share: the window's groups or jobs
that ran without the profiler, sums of the program's phase timers over
them, the device's idle share and kernel counts from a traced stretch, and
the names of the port's own kernels (its ``__global__`` functions)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

from port_bench import harness

CSRC = harness.ROOT / "clip_gp_tpu_torch" / "csrc"


def untraced(units: List[Dict]) -> List[Dict]:
    """The window's units (groups, jobs) that ran without the profiler,
    or all of them where every one was traced."""
    plain = [u for u in units if u.get("trace") is None]
    return plain or units


def phase(units: List[Dict], *names: str) -> float:
    return sum(u["phases"].get(n, 0.0) for u in units for n in names)


def traced(units: List[Dict]) -> Optional[Dict]:
    for u in units:
        if u.get("trace") is not None:
            return u["trace"]
    return None


def idle_percent(summary: Optional[Dict]) -> Optional[float]:
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def kernels_between(summary: Dict, marker: str) -> Optional[float]:
    """Device kernels that start between the first and the last of the
    benchmark's ``marker`` events, per interval between two markers."""
    marks = summary["markers"].get(marker, [])
    if len(marks) < 2:
        return None
    lo, hi = marks[0], marks[-1]
    n = sum(1 for s in harness.kernel_starts(summary) if lo <= s < hi)
    return n / (len(marks) - 1) if n else None


def port_kernels(csrc: Path = CSRC) -> List[str]:
    """Names of the ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            rest = re.sub(r"^\s*(void\s+)?", "", text[m.end():])
            if rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                while True:
                    depth += {"(": 1, ")": -1}.get(rest[i], 0)
                    i += 1
                    if depth == 0:
                        break
                rest = re.sub(r"^\s*(void\s+)?", "", rest[i:])
            names.add(re.match(r"\w+", rest).group())
    return sorted(names)


def port_kernel_seconds(summary: Dict, names: List[str]) -> float:
    pattern = re.compile(r"(?<!\w)(" + "|".join(map(re.escape, names)) + r")(?=[<(])")
    return sum(e - s for n, s, e in summary["device"] if pattern.search(n)) / 1e9
