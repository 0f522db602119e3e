"""npz checkpoints of small nested-dict states, byte-compatible with the JAX
package's (``clip_gp_tpu/runtime/checkpoint.py``): nested keys flatten to
``a/b/c`` (list items by index) and every leaf is stored as a numpy array,
so either package reads what the other wrote. ``_unflatten`` reads them back
(numbered levels become lists, as the JAX package's ``_unflatten``).
"""

from __future__ import annotations

import re
from typing import Any, Dict

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
