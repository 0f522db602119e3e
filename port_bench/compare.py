"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the plain reference computes, in float64, and
each has its limit in ``limits/<cell>.json``.

- ``rows``: the worst row's ``||p - r|| / ||r||`` (features, embeddings);
- ``leaf_norms``: per leaf, ``| ||p|| - ||r|| |`` over the larger of
  ``||r||`` and the median leaf's norm, worst leaf (a gradient, or the
  change of the parameters over steps). What moves by round-off alone is
  left out of a change (``moving``): a leaf whose reference gradient is
  under a thousandth of the median leaf's, and within a leaf each entry
  whose reference gradient is under a thousandth of the leaf's root mean
  square (Adam moves an entry by about its learning rate whatever the size
  of its gradient, so the sign of round-off sets where such an entry goes);
- ``scaled``: ``max |p - r| / max |r|`` (losses, Gram matrices, logits);
- ``largest``: ``max |p - r|`` in the quantity's own unit (metrics in
  percent, probabilities).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).double().cpu()


def rows(p, r) -> float:
    p, r = _t(p), _t(r)
    p, r = p.reshape(-1, p.shape[-1]), r.reshape(-1, r.shape[-1])
    return float(((p - r).norm(dim=-1) / r.norm(dim=-1)).max())


def scaled(p, r) -> float:
    p, r = _t(p), _t(r)
    return float((p - r).abs().max() / r.abs().max())


def largest(p, r) -> float:
    return float((_t(p) - _t(r)).abs().max())


def norms(tree: Dict) -> Dict[str, float]:
    return {n: float(_t(v).norm()) for n, v in tree.items()}


def moving(ref_grad: Dict) -> Dict[str, torch.Tensor]:
    """{leaf: mask of the entries that the reference's gradient moves},
    for the leaves that it moves."""
    n = norms(ref_grad)
    median = float(np.median(list(n.values())))
    out = {}
    for k, g in ref_grad.items():
        if n[k] >= 1e-3 * median:
            g = _t(g).abs()
            out[k] = g >= 1e-3 * g.square().mean().sqrt()
    return out


def leaf_norms(p: Dict, r: Dict, masks: Optional[Dict[str, torch.Tensor]] = None) -> float:
    if masks is None:
        masks = {k: None for k in r}
    pick = {k: (lambda x, m=m: _t(x) if m is None else _t(x)[m]) for k, m in masks.items()}
    keep = list(masks)
    pn = norms({k: pick[k](p[k]) for k in keep})
    rn = norms({k: pick[k](r[k]) for k in keep})
    median = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], median) for k in keep)


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {"value", "limit"}} for every number compared; a number
    without a limit is an error of the benchmark."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in values.items()}


def correct(checks: Dict[str, Dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
