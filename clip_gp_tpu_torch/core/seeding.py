"""Reproducibility: one seed feeds python/numpy/torch and a generator stream.

The reference seeds python/numpy/torch globally (ref:
utils/reproducibility.py:10). Device randomness in the port is explicit:
``KeySequence`` hands out independent ``torch.Generator``s derived from the
run seed, the counterpart of the JAX package's key stream (whose draws a
torch generator cannot reproduce). Host-side sampling (few-shot splits,
epoch shuffles) uses ``random``/``numpy`` exactly like the reference so split
files stay compatible.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from clip_gp_tpu_torch.core.device import resolve_device


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_random_state():
    """The host streams' states (ref: utils/reproducibility.py:42-59): python
    ``random`` and numpy, as the JAX package snapshots them. Device noise
    comes from ``KeySequence``, which the run seed alone determines."""
    return {"python": random.getstate(), "numpy": np.random.get_state()}


def set_random_state(state) -> None:
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])


class KeySequence:
    """Deterministic stream of ``torch.Generator``s on ``device`` (by default
    the GPU, see ``core/device.py``) derived from the run seed; each
    ``next()`` seeds fresh generators from a numpy ``SeedSequence`` child, so
    streams never overlap.

    ``SeedSequence`` takes only non-negative entropy, while the JAX package
    takes any int seed (``jax.random.key(-1)`` is valid), so the seed enters
    modulo 2**64: one-to-one over the int64 seeds and over 0 .. 2**64 - 1,
    and a non-negative seed keeps its stream."""

    def __init__(self, seed: int, device=None):
        self._seq = np.random.SeedSequence(int(seed) & (2**64 - 1))
        self.device = resolve_device(device)

    def next(self, n: int = 1):
        gens = []
        for child in self._seq.spawn(n):
            g = torch.Generator(device=self.device)
            g.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0] >> 1))
            gens.append(g)
        return gens[0] if n == 1 else gens
