"""Disk and in-process cache of the frozen image tower's features on the
deterministic evaluation splits, as the JAX package's
``runtime/feature_cache.py``.

Every trial of a sweep re-encodes the same val and test splits; their
preprocessing is deterministic (resize, center crop, no augmentation), so
their features are cached keyed by backbone, weights, input size and
normalization, split content and the tower that encoded them, and a later
trial loads [N, D] float32 instead of running the tower. The train split is
never cached: its extraction draws the augmentation, and only callers that
pass ``cacheable=True`` reach this module.

Enable the disk cache with ``CLIP_GP_TPU_TORCH_FEATURE_CACHE=<dir>`` (``1``
means ``~/.cache/clip_gp_tpu_torch/features``). The in-process memo is
always on. It holds host numpy arrays only, never a device tensor, so it
pins no device memory across trainers.

Keys carry a ``torch-<device type>`` tag: the JAX package's keys have none,
and a CPU encode differs from a GPU encode at the ULP level, so entries of
another framework or device never alias. The int8 tower's label is ``int8``
(the port has one int8 tower, with per-head scales like the JAX package's
fused Pallas tower).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# small LRU: entries are [N, D] float32 (ImageNet-val is ~100 MB)
_MEMO: "OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
_MEMO_MAX_ENTRIES = 4
_MEMO_LOCK = threading.Lock()


def memo_get(key: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    with _MEMO_LOCK:
        hit = _MEMO.get(key)
        if hit is not None:
            _MEMO.move_to_end(key)
        return hit


def memo_put(key: str, labels: np.ndarray, features: np.ndarray) -> None:
    if not (isinstance(labels, np.ndarray) and isinstance(features, np.ndarray)):
        raise TypeError("the feature memo holds host numpy arrays only")
    with _MEMO_LOCK:
        _MEMO[key] = (labels, features)
        _MEMO.move_to_end(key)
        while len(_MEMO) > _MEMO_MAX_ENTRIES:
            _MEMO.popitem(last=False)


def memo_clear() -> None:
    with _MEMO_LOCK:
        _MEMO.clear()


# per-key in-flight locks: a second trainer that misses the memo for a split
# another thread is encoding waits for that encode instead of repeating it
_INFLIGHT: Dict[str, "threading.Lock"] = {}


def inflight_lock(key: str) -> "threading.Lock":
    with _MEMO_LOCK:
        lk = _INFLIGHT.get(key)
        if lk is None:
            lk = _INFLIGHT[key] = threading.Lock()
        return lk


def cache_dir() -> Optional[Path]:
    value = os.environ.get("CLIP_GP_TPU_TORCH_FEATURE_CACHE")
    if not value:
        return None
    if value == "1":
        return Path.home() / ".cache" / "clip_gp_tpu_torch" / "features"
    return Path(value)


def split_fingerprint(impaths: List[str], labels: List[int]) -> str:
    h = hashlib.sha256()
    for p, y in zip(impaths, labels):
        h.update(p.encode())
        h.update(str(y).encode())
    return h.hexdigest()[:20]


def cache_key(config, split_items, weights_tag: str, *, device_type: str,
              int8: bool, shard_devices: int = 0) -> str:
    """Disk and memo key of one (weights, preprocessing, split, tower)
    extraction: the JAX package's key, then ``torch-<device_type>``.

    ``int8``: whether the int8 tower really encodes this split (the flag and
    a ViT tower), so an fp32 encode is never stored under the int8 label.

    ``shard_devices``: above 1 when extraction splits the batch over that
    many local devices (``parallel/mesh.py``); the key then carries the JAX
    package's ``dp<N>`` part. Chunked launches may differ from one launch at
    the ULP level, so entries of either provenance never alias."""
    impaths = [it.impath for it in split_items]
    labels = [it.label for it in split_items]
    norm = hashlib.sha256(
        repr((tuple(config.input.pixel_mean), tuple(config.input.pixel_std))).encode()
    ).hexdigest()[:8]
    parts = [
        config.model.backbone_name.replace("/", "-"),
        weights_tag,
        f"{config.input.size[0]}x{config.input.size[1]}",
        config.input.interpolation,
        norm,
        split_fingerprint(impaths, labels),
    ]
    if int8:
        parts.append("int8")
    if shard_devices and shard_devices > 1:
        parts.append(f"dp{shard_devices}")
    parts.append(f"torch-{device_type}")
    return "_".join(parts)


def load(key: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    d = cache_dir()
    if d is None:
        return None
    path = d / f"{key}.npz"
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as data:
            return data["labels"], data["features"]
    except Exception:
        # a torn or foreign file: drop it and encode again
        try:
            path.unlink()
        except OSError:
            pass
        return None


def store(key: str, labels: np.ndarray, features: np.ndarray) -> None:
    d = cache_dir()
    if d is None:
        return
    d.mkdir(parents=True, exist_ok=True)
    # through a handle: np.savez would append ".npz" to a bare temp name
    tmp = d / f"{key}.tmp.{os.getpid()}"
    with tmp.open("wb") as f:
        np.savez_compressed(f, labels=labels, features=features)
    tmp.replace(d / f"{key}.npz")
