"""ctypes loader for the native fast-decode library, with on-demand build:
the port of the JAX package's ``native/loader.py``.

The shared object is compiled once into ``build/native/`` at the repository
root (keyed by a hash of the source) with ``g++ -O3 -shared -fPIC ...
-ljpeg -ldl``. Every entry point degrades gracefully: if the toolchain, the
libjpeg headers or the library are missing, ``native_available()`` is False,
``unavailable_reason()`` says why, and callers use the PIL path.
``CLIP_GP_TPU_TORCH_DISABLE_NATIVE=1`` switches the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "fast_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_REASON: Optional[str] = None
_BUILD_LOCK = threading.Lock()


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _TRIED, _REASON
    _TRIED = True
    if os.environ.get("CLIP_GP_TPU_TORCH_DISABLE_NATIVE") == "1":
        _REASON = "CLIP_GP_TPU_TORCH_DISABLE_NATIVE=1"
        return None
    try:
        src = _SRC.read_bytes()
    except OSError as e:
        _REASON = f"source unreadable ({e})"
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libfastdecode-{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per-process AND per-thread tmp name: the sweep's subprocess backend
        # and BatchLoader's worker processes can cold-build from N processes
        # at once, and one process's threads can too —
        # a pid-only tmp would let two in-process threads' linkers interleave
        # writes into one file and rename a corrupt .so into the hash-keyed
        # cache, permanently (it would never be rebuilt)
        tmp = lib_path.with_suffix(
            f".so.tmp.{os.getpid()}.{threading.get_ident()}"
        )
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            str(_SRC), "-ljpeg", "-ldl", "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            tmp.replace(lib_path)
        except Exception as e:
            detail = ""
            stderr = getattr(e, "stderr", None)
            if stderr:
                if isinstance(stderr, bytes):
                    stderr = stderr.decode(errors="replace")
                detail = f"\n[native] compiler said: {stderr[-500:]}"
            _REASON = f"build failed ({e}){detail}"
            # stderr, not stdout: a caller's stdout may be a JSON contract
            print(
                f"[native] fast_decode build failed ({e}); using PIL path"
                f"{detail}",
                file=sys.stderr,
            )
            return None
        finally:
            tmp.unlink(missing_ok=True)  # failed/timed-out partial object
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        _REASON = f"load failed ({e})"
        return None
    lib.decode_resize_crop.restype = ctypes.c_int
    lib.decode_resize_crop.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.jpeg_dims.restype = ctypes.c_int
    lib.jpeg_dims.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.decode_rrc.restype = ctypes.c_int
    lib.decode_rrc.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.set_partial_decode.restype = None
    lib.set_partial_decode.argtypes = [ctypes.c_int]
    lib.partial_decode_supported.restype = ctypes.c_int
    lib.partial_decode_supported.argtypes = []
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None and not _TRIED:
        # first use typically comes from several pool workers at once; only
        # one may build (the others wait, then read the cached result)
        with _BUILD_LOCK:
            if _LIB is None and not _TRIED:
                _LIB = _build_and_load()
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why ``native_available()`` is False (the build's error, the disabling
    variable), or None when the library loaded."""
    _get_lib()
    return _REASON


def decode_resize_crop(jpeg_bytes: bytes, target: int) -> Optional[np.ndarray]:
    """JPEG bytes → uint8 [target, target, 3], or None (caller falls back)."""
    lib = _get_lib()
    if lib is None:
        return None
    out = np.empty((target, target, 3), dtype=np.uint8)
    rc = lib.decode_resize_crop(
        jpeg_bytes,
        len(jpeg_bytes),
        target,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    return out


def jpeg_dims(jpeg_bytes: bytes) -> Optional[tuple]:
    """(width, height) from the JPEG header only, or None."""
    lib = _get_lib()
    if lib is None:
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.jpeg_dims(
        jpeg_bytes, len(jpeg_bytes), ctypes.byref(w), ctypes.byref(h)
    )
    if rc != 0:
        return None
    return (w.value, h.value)


def set_partial_decode(enabled: bool) -> None:
    """Toggle windowed (partial) JPEG decompression on the train path —
    tests turn it off to prove bit-parity against the full decode."""
    lib = _get_lib()
    if lib is not None:
        lib.set_partial_decode(1 if enabled else 0)


def partial_decode_supported() -> bool:
    """True when libjpeg-turbo's partial-decompression entry points resolved
    (jpeg_crop_scanline + jpeg_skip_scanlines); False when decode_rrc is
    silently degrading to full decodes. Lets the bit-parity test assert the
    windowed path actually engaged instead of passing vacuously."""
    lib = _get_lib()
    return lib is not None and bool(lib.partial_decode_supported())


def decode_rrc(
    jpeg_bytes: bytes, box, target: int, flip: bool
) -> Optional[np.ndarray]:
    """Train-path: decode → crop ``box`` (x, y, w, h in original coords) →
    bicubic resize to target×target → optional horizontal flip. The crop
    window is sampled by the CALLER (augmentation RNG stays in Python,
    per-item seeded — the reproducibility contract)."""
    lib = _get_lib()
    if lib is None:
        return None
    x, y, w, h = (float(v) for v in box)
    out = np.empty((target, target, 3), dtype=np.uint8)
    rc = lib.decode_rrc(
        jpeg_bytes,
        len(jpeg_bytes),
        x, y, w, h,
        target,
        1 if flip else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    return out
