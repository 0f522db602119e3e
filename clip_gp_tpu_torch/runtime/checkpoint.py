"""npz checkpoints of small nested-dict states, byte-compatible with the JAX
package's (``clip_gp_tpu/runtime/checkpoint.py``): nested keys flatten to
``a/b/c`` (list items by index) and every leaf is stored as a numpy array,
so either package reads what the other wrote. ``_unflatten`` reads them back
(numbered levels become lists, as the JAX package's ``_unflatten``).

The trainers save and load through ``BaseTrainer.save_model``/``load_model``;
``save_checkpoint``, ``load_checkpoint``, ``load_pretrained_weights`` and
``resume_from_checkpoint`` are the reference's generic surface (ref:
utils/checkpoint.py) over any nested state, in the same npz layout.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        flat[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]):
    """Inverse of ``_flatten``: ``a/b/c`` keys back to nested dicts of numpy
    arrays, with a level whose keys are all 0..n-1 read back as a list."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(re.fullmatch(r"\d+", k) for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _normalize(path) -> str:
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def save_checkpoint(state: Dict[str, Any], path, epoch: Optional[int] = None) -> None:
    """Save a nested state (and an optional epoch tag) as compressed npz. Any
    ``path`` round-trips through :func:`load_checkpoint`: ``np.savez``
    appends ``.npz`` to a name without it, so both sides normalize."""
    path = _normalize(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    extra = {}
    if epoch is not None:
        extra["__epoch__"] = np.asarray(epoch)
    np.savez_compressed(path, **_flatten(state), **extra)


def load_checkpoint(path) -> Tuple[Dict[str, Any], Optional[int]]:
    """(nested state of numpy arrays, epoch or None)."""
    with np.load(_normalize(path), allow_pickle=False) as data:
        epoch = int(data["__epoch__"]) if "__epoch__" in data.files else None
        flat = {k: data[k] for k in data.files if k != "__epoch__"}
    return _unflatten(flat), epoch


def load_pretrained_weights(params: Dict[str, Any], path) -> Dict[str, Any]:
    """Overlay a checkpoint's arrays onto ``params`` where the key and the
    shape match, reporting the rest (the analog of the reference's loader
    that strips the ``module.`` prefix, ref: utils/checkpoint.py:12).
    Returns a nested state of numpy arrays."""
    loaded, _ = load_checkpoint(path)
    flat_params = _flatten(params)
    matched, skipped = 0, []
    for key, val in _flatten(loaded).items():
        if key in flat_params and flat_params[key].shape == val.shape:
            flat_params[key] = val
            matched += 1
        else:
            skipped.append(key)
    if skipped:
        print(f"Skipped {len(skipped)} mismatched keys: {skipped[:5]}...")
    print(f"Loaded {matched} arrays from {path}")
    return _unflatten(flat_params)


def resume_from_checkpoint(ckpt_dir, prefix: str = "model.ckpt-"):
    """The highest-numbered checkpoint in a directory: (state, epoch), or
    (None, 0) when there is none."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None, 0

    def _num(p: Path) -> int:
        m = re.search(r"(\d+)", p.stem)
        return int(m.group(1)) if m else -1  # digit-less names sort first

    cands = sorted(d.glob(f"{prefix}*.npz"), key=_num)
    if not cands:
        return None, 0
    state, epoch = load_checkpoint(cands[-1])
    return state, epoch or 0


def find_run_checkpoint(model_dir, epoch: Optional[int], prefix: str, suffix: str,
                        best: str) -> Optional[Path]:
    """``<model_dir>/adapter`` checkpoint discovery: an explicit epoch, else
    ``best``, else the highest-numbered ``<prefix>N<suffix>`` (ref:
    utils/trainer.py:376-399); None if there is none."""
    adapter_dir = Path(model_dir) / "adapter"
    if epoch is not None:
        path = adapter_dir / f"{prefix}{epoch}{suffix}"
        return path if path.exists() else None
    if (adapter_dir / best).exists():
        return adapter_dir / best
    cands = sorted(
        adapter_dir.glob(f"{prefix}*{suffix}"),
        key=lambda p: int(re.search(r"(\d+)", p.name[len(prefix):]).group(1)),
    )
    return cands[-1] if cands else None
