"""What the readers of the program's own spans share: the span log of
``clip_gp_tpu_torch/runtime/profiling.py`` (``spans()``, ``dropped()``,
``trace_ns``), the spans of a window's group or job, and the device's idle
seconds inside spans, on the profiler's clock.

Each reading is None where there is nothing to read: a program without the
span log, a group or job whose spans are missing, or spans inside it that
the bounded log dropped."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple


class Log:
    """A snapshot of the program's span log."""

    def __init__(self, spans: Sequence, dropped: int, trace_ns):
        # spans are logged as they end, so every dropped span ended no later
        # than the oldest one kept
        self.kept_from = spans[0].end_ns if dropped and spans else None
        self.spans = sorted(spans, key=lambda s: s.start_ns)
        self.trace_ns = trace_ns

    def whole(self, outer) -> bool:
        """No span that started inside ``outer`` was dropped."""
        return self.kept_from is None or self.kept_from <= outer.start_ns

    def named(self, name: str) -> List:
        return [s for s in self.spans if s.name == name]

    def inside(self, outer, name: str) -> List:
        """The ``name`` spans opened inside ``outer`` on its thread."""
        return [s for s in self.spans if s.name == name and s.thread == outer.thread
                and outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns]

    def group(self, rec: Dict):
        """The ``vmap.group`` span of a window's group record (its trial
        seeds and shots), or None."""
        found = [s for s in self.named("vmap.group")
                 if list(s.attrs.get("seeds", ())) == list(rec["seeds"])
                 and s.attrs.get("shots") == rec["shots"]]
        return found[0] if len(found) == 1 and self.whole(found[0]) else None

    def jobs(self, n: int) -> Optional[List]:
        """The ``feature_extraction`` spans of the window's ``n`` folder
        jobs: the last ``n``, in order."""
        found = self.named("feature_extraction")[-n:] if n > 0 else []
        if not found or len(found) != n or not self.whole(found[0]):
            return None
        return found


def log() -> Optional[Log]:
    from clip_gp_tpu_torch.runtime import profiling

    if not hasattr(profiling, "spans"):
        return None
    return Log(profiling.spans(), profiling.dropped(), profiling.trace_ns)


def seconds(spans: Sequence) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(b, merged[-1][1]))
        else:
            merged.append((a, b))
    return merged


def idle_share(log: Log, summary: Dict, spans: Sequence) -> Optional[float]:
    """Percent of the traced stretch's device-idle seconds (its window less
    the union of its device ops) that lie inside ``spans``."""
    idle = summary["window_s"] - summary["busy_s"]
    if not spans or idle <= 0:
        return None
    busy = _merge([(s, e) for _, s, e in summary["device"]])
    starts = [a for a, _ in busy]
    inside = 0
    for a, b in _merge([(log.trace_ns(s.start_ns), log.trace_ns(s.end_ns)) for s in spans]):
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        inside += (b - a) - covered
    return 100.0 * inside / 1e9 / idle
