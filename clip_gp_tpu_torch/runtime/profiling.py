"""Tracing and profiling hooks, as the JAX package's ``runtime/profiling.py``.

- ``phase_timer``: named wall-clock phases, accumulated into a per-process
  report (``phase_report``; the trainers time ``feature_extraction`` and
  ``train_epochs``). Given a CUDA ``device``, a phase ends with
  ``torch.cuda.synchronize``: kernels launch asynchronously, and without it
  a phase would count only the host's launches;
- ``maybe_trace``: wraps a block in ``torch.profiler.profile`` when
  ``CLIP_GP_TPU_TORCH_PROFILE_DIR`` is set (CPU activity, plus CUDA on a
  CUDA device) and writes a Chrome trace under ``<dir>/<label>/``;
  otherwise it does nothing;
- ``annotate``: a named ``torch.profiler.record_function`` range, so a
  phase shows up on the trace's timeline.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)
# trainers on concurrent threads time same-named phases; an unguarded +=
# would drop additions
_PHASE_LOCK = threading.Lock()


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = False, device=None) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        if _is_cuda(device):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - start
        with _PHASE_LOCK:
            _PHASE_TOTALS[name] += dt
            _PHASE_COUNTS[name] += 1
        if verbose:
            print(f"[profile] {name}: {dt:.3f}s")


def phase_report() -> Dict[str, Dict[str, float]]:
    with _PHASE_LOCK:
        return {
            name: {"total_s": total, "count": _PHASE_COUNTS[name]}
            for name, total in sorted(_PHASE_TOTALS.items())
        }


def reset_phases() -> None:
    with _PHASE_LOCK:
        _PHASE_TOTALS.clear()
        _PHASE_COUNTS.clear()


@contextlib.contextmanager
def maybe_trace(label: str = "run", device=None) -> Iterator[None]:
    """A ``torch.profiler`` trace when CLIP_GP_TPU_TORCH_PROFILE_DIR is set;
    nothing otherwise."""
    profile_dir: Optional[str] = os.environ.get("CLIP_GP_TPU_TORCH_PROFILE_DIR")
    if not profile_dir:
        yield
        return
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range on the trace's timeline."""
    with torch.profiler.record_function(name):
        yield
