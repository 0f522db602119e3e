"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
importing nothing of JAX, of the JAX package or of the port."""

import contextlib

import torch


@contextlib.contextmanager
def products(tf32: bool):
    """fp32 matrix products and convolutions in TF32 (the control) or in
    full fp32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
