"""Build and load the hand-written CUDA kernels (``clip_gp_tpu_torch/csrc``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Each ``.cu`` compiles in its own ``nvcc`` process, all
started together, then one link. The build runs at the first kernel launch
of a process, into ``build/kernels/`` at the repository root, named by a
hash of the sources and flags so an edited source never loads a stale
library. Nothing here runs at import: a host without ``nvcc`` or a GPU
imports every module of the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
# C signatures of csrc/*.cu (pointers and the stream as void*)
SIGNATURES = {
    "cgt_ln_stats": [_c_void_p, _c_void_p, _c_int, _c_int, _c_void_p],
    "cgt_gemm": [_c_void_p] * 5 + [_c_int] * 6 + [_c_void_p],
    "cgt_ln_apply": [_c_void_p] * 5 + [_c_int] * 2 + [_c_void_p],
    "cgt_attention": [_c_void_p, _c_void_p, _c_void_p] + [_c_int] * 5
    + [_c_void_p],
    "cgt_attention_tiled": [_c_void_p, _c_void_p, _c_void_p] + [_c_int] * 5
    + [_c_void_p],
    "cgt_gemm_bwd": [_c_void_p] * 6 + [_c_int] * 7 + [_c_void_p],
    "cgt_ln_f32": [_c_void_p] * 5 + [_c_int] * 3 + [_c_void_p],
    "cgt_attention_bwd": [_c_void_p] * 6 + [_c_int] * 4 + [_c_void_p],
    "cgt_ln_bwd": [_c_void_p] * 6 + [_c_int] * 3 + [_c_void_p],
    "cgt_ln_param_grads": [_c_void_p] * 6 + [_c_int] * 4 + [_c_void_p],
    "cgt_colsum": [_c_void_p] * 3 + [_c_int] * 4 + [_c_void_p],
    "cgt_sum_parts": [_c_void_p, _c_void_p, _c_int, _c_int, _c_void_p],
    "cgt_q8_quantize": [_c_void_p] * 5 + [_c_int] * 3 + [_c_void_p],
    "cgt_q8_gemm": [_c_void_p] * 7 + [_c_int] * 6 + [_c_void_p],
    "cgt_attention_q8": [_c_void_p] * 4 + [_c_int] * 5 + [_c_void_p],
    "cgt_attention_bhnd": [_c_void_p] * 5 + [_c_int] * 5 + [_c_void_p],
}

_lib: Optional[ctypes.CDLL] = None
# one build per process, whichever thread launches first
_LIB_LOCK = threading.Lock()
# guards the wrappers' LAUNCHES counters: threads driving several devices
# (the sweep's group-parallel workers) launch at once
_COUNT_LOCK = threading.Lock()
# what the last build did, for chip_smoke.py's report
last_build = {"seconds": 0.0, "cached": True, "ptxas": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build on a host with the CUDA "
        "toolkit (PATH or CUDA_HOME)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/libclip_gp_kernels-<hash>.so``
    unless that file exists; return its path. Raises with nvcc's output on a
    failed compile."""
    target = BUILD_DIR / f"libclip_gp_kernels-{_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs)
            )
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *[str(o) for o in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, target)  # atomic: no reader sees a partial file
    last_build.update(
        seconds=time.perf_counter() - start, cached=False, ptxas="\n".join(logs)
    )
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``, exact under concurrent threads."""
    with _COUNT_LOCK:
        counts[name] += 1


def reset_counts(counts: Dict[str, int]) -> None:
    with _COUNT_LOCK:
        for name in counts:
            counts[name] = 0


def on_tensor_device(fn):
    """Run ``fn`` with its first CUDA tensor argument's device as the
    thread's current device. The C entry points ask ``cudaGetDevice`` where
    to opt in to shared memory and launch, while the wrappers pass the
    stream of the tensor's device: a thread whose current device is another
    card (a group-parallel worker, a trial slice) would launch on the wrong
    one."""

    @functools.wraps(fn)
    def guarded(*args, **kwargs):
        for a in args:
            if isinstance(a, torch.Tensor):
                if a.is_cuda:
                    with torch.cuda.device(a.device):
                        return fn(*args, **kwargs)
                break
        return fn(*args, **kwargs)

    return guarded
