"""The port's one tracing module: a span log, the phase timers of the JAX
package's ``runtime/profiling.py`` and its trace exporter.

- ``span(name, **attrs)``: a context manager that records one span into a
  bounded in-memory log (``spans()``): its id, name, thread, start and end
  (``time.perf_counter_ns()``), the id of the span open around it on the
  same thread (``parent``) and that of the outermost one (``root``, so the
  spans of one sweep group or one served job share an identifier), and
  its attributes. The log keeps the newest ``LOG_SIZE`` spans and counts
  the ones it dropped (``dropped()``). While a ``torch.profiler`` session
  records the thread, a span is also a range of the same name on the
  profiler's timeline; ``trace_ns`` puts a span's times on that timeline's
  clock. Without a profiler a span only reads the clock twice and appends
  to the log;
- ``phase_timer``: a span whose time also adds to a per-process report
  (``phase_report``; the trainers time ``feature_extraction`` and
  ``train_epochs``). Given a CUDA ``device``, a phase ends with
  ``torch.cuda.synchronize``: kernels launch asynchronously, and without it
  a phase would count only the host's launches;
- ``maybe_trace``: wraps a block in ``torch.profiler.profile`` when
  ``CLIP_GP_TPU_TORCH_PROFILE_DIR`` is set (CPU activity, plus CUDA on a
  CUDA device) and writes a Chrome trace under ``<dir>/<label>/``;
  otherwise it does nothing.

The spans the program opens, by where the work happens: ``vmap.group``
(a trial-batched group, the root of ``VmappedTrials.run``; attributes
``method``, ``shots``, ``trials``, ``seeds``), ``vmap.step`` (one step's
host issue, attribute ``step``), ``vmap.prefetch`` (decode-ahead's producer
thread, the ``seeds`` and ``shots`` of the group it decodes for),
``data.decode_batch`` (a ``BatchLoader`` batch, attribute ``images``),
``data.wait_batch``, ``tower.issue`` and ``data.to_host`` (an extraction
waiting for the loader, issuing the image tower and copying the features
back), and every phase timer.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Any, Deque, Dict, Iterator, List, NamedTuple, Optional

import torch

LOG_SIZE = 65536


class Span(NamedTuple):
    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    attrs: Dict[str, Any]


_LOG: Deque[Span] = deque(maxlen=LOG_SIZE)
_dropped = 0
_LOG_LOCK = threading.Lock()
_IDS = itertools.count(1)
# per thread: (id, root) of each open span, innermost last
_OPEN = threading.local()
# torch.profiler stamps host events in Unix-epoch nanoseconds
_TRACE_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)
# trainers on concurrent threads time same-named phases; an unguarded +=
# would drop additions
_PHASE_LOCK = threading.Lock()
# one profiler session at a time in the process
_TRACE_LOCK = threading.Lock()


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def trace_ns(t_ns: int) -> int:
    """A span time (``perf_counter_ns``) on ``torch.profiler``'s clock."""
    return t_ns + _TRACE_OFFSET_NS


class _Span:
    """One open span; ``attrs`` may be filled in until it ends."""

    __slots__ = ("name", "attrs", "_sync", "_phase", "_keep", "_id", "_parent",
                 "_root", "_range", "_start")

    def __init__(self, name: str, attrs: Dict[str, Any], sync=None, phase: bool = False):
        self.name, self.attrs, self._sync, self._phase = name, attrs, sync, phase
        self._keep = True

    def discard(self) -> None:
        """Leave this span out of the log."""
        self._keep = False

    def __enter__(self) -> "_Span":
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self._id = next(_IDS)
        self._parent, self._root = stack[-1] if stack else (None, self._id)
        stack.append((self._id, self._root))
        self._range = None
        if torch.autograd._profiler_enabled():
            # a function-scope range: a user-scope one (record_function) is
            # also drawn on the device's timeline over the kernels launched
            # inside it, where a reading of the trace would count it as
            # device work
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        try:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
        finally:
            end = time.perf_counter_ns()
            if self._range is not None:
                self._range.__exit__(None, None, None)
            _OPEN.stack.pop()
            if self._keep:
                record = Span(self._id, self.name, threading.get_ident(), self._start, end,
                              self._parent, self._root, self.attrs)
                with _LOG_LOCK:
                    if len(_LOG) == LOG_SIZE:
                        _dropped += 1
                    _LOG.append(record)
            if self._phase:
                with _PHASE_LOCK:
                    _PHASE_TOTALS[self.name] += (end - self._start) / 1e9
                    _PHASE_COUNTS[self.name] += 1


def span(name: str, **attrs) -> _Span:
    return _Span(name, attrs)


def phase_timer(name: str, device=None) -> _Span:
    return _Span(name, {}, sync=device if _is_cuda(device) else None, phase=True)


def spans() -> List[Span]:
    """The log's spans, oldest first (in the order they ended)."""
    with _LOG_LOCK:
        return list(_LOG)


def dropped() -> int:
    """Spans the bounded log has dropped since the last ``reset_phases``."""
    return _dropped


def phase_report() -> Dict[str, Dict[str, float]]:
    with _PHASE_LOCK:
        return {
            name: {"total_s": total, "count": _PHASE_COUNTS[name]}
            for name, total in sorted(_PHASE_TOTALS.items())
        }


def reset_phases() -> None:
    """Clear the phase report and the span log."""
    global _dropped
    with _PHASE_LOCK:
        _PHASE_TOTALS.clear()
        _PHASE_COUNTS.clear()
    with _LOG_LOCK:
        _LOG.clear()
        _dropped = 0


@contextlib.contextmanager
def maybe_trace(label: str = "run", device=None) -> Iterator[None]:
    """A ``torch.profiler`` trace when CLIP_GP_TPU_TORCH_PROFILE_DIR is set;
    nothing otherwise, and nothing while another block is being traced."""
    profile_dir: Optional[str] = os.environ.get("CLIP_GP_TPU_TORCH_PROFILE_DIR")
    if not profile_dir or not _TRACE_LOCK.acquire(blocking=False):
        yield
        return
    try:
        from torch.profiler import ProfilerActivity, profile

        out = os.path.join(profile_dir, label)
        os.makedirs(out, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if _is_cuda(device):
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        path = os.path.join(out, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        print(f"[profile] torch trace written to {path}")
    finally:
        _TRACE_LOCK.release()
