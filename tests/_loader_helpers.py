"""Transforms for ``BatchLoader`` tests. A worker process unpickles a
loader's transform by importing its module, so these live in a module of
their own that imports neither torch nor the test modules."""

import os
import sys
import time

import numpy as np


class Plain:
    """The image's own pixels."""

    uses_rng = False

    def __call__(self, img, rng=None):
        return np.asarray(img, dtype=np.uint8)


class Slow(Plain):
    """``Plain``, ``seconds`` later."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __call__(self, img, rng=None):
        time.sleep(self.seconds)
        return super().__call__(img, rng)


class Modules:
    """A 1x3 image: whether torch is loaded where it runs, whether that
    process ran a ``__main__`` from a file (the parent's entry script, run
    again), and whether it imported the test modules."""

    uses_rng = False

    def __call__(self, img, rng=None):
        flags = ("torch" in sys.modules, hasattr(sys.modules["__main__"], "__file__"),
                 "test_torch_loader" in sys.modules)
        return np.asarray([[flags]], dtype=np.uint8)


class Exit:
    """Ends the process that decodes the image."""

    uses_rng = False

    def __call__(self, img, rng=None):
        os._exit(3)
