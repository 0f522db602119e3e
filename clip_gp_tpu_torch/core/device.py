"""Where the port runs: the GPU unless the caller asks for the CPU.

``resolve_device()`` returns ``cuda`` when a GPU is present, ``cpu`` when
``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` is set (the counterpart of the JAX
package's ``CLIP_GP_TPU_FORCE_CPU``; the tests set it), and raises otherwise:
the port never carries on silently on the CPU. An explicit ``device`` wins,
then a device pinned to the calling thread with ``pinned_device`` (the
sweep's group-parallel workers: a trainer built in a worker lands on its
device without being told).

``local_devices()`` lists the devices a multi-device path spreads over: the
CUDA devices, or the one CPU under ``CLIP_GP_TPU_TORCH_FORCE_CPU=1``; none
on a host with neither, where ``resolve_device`` raises.

``device_label()`` names the card a measurement ran on, as ``nvidia-smi``
names it with its power limit, or ``"cpu"``: the scripts' reports carry it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
from typing import Iterator, List, Optional, Union

import torch

_PIN = threading.local()


def local_devices() -> List[torch.device]:
    """The devices of this process: ``[cpu]`` when the caller asks for the
    CPU, else every CUDA device (none without a GPU: a caller that runs
    anything resolves its device, and that raises)."""
    if os.environ.get("CLIP_GP_TPU_TORCH_FORCE_CPU") == "1":
        return [torch.device("cpu")]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return []


def pinned() -> Optional[torch.device]:
    """The device pinned to the calling thread, or None."""
    return getattr(_PIN, "device", None)


@contextlib.contextmanager
def pinned_device(device: Union[str, torch.device]) -> Iterator[torch.device]:
    """Pin ``device`` to the calling thread: inside, ``resolve_device(None)``
    returns it, and a CUDA device is the thread's current device. Nests."""
    device = torch.device(device)
    prev = pinned()
    _PIN.device = device
    try:
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield device
        else:
            yield device
    finally:
        _PIN.device = prev


def configure_cuda_numerics() -> None:
    """Full-fp32 matrix products and convolutions on the GPU. cuDNN runs fp32
    convolutions (the ViT patch embed) in TF32 by default, which moves fp32
    features by ~1e-3 against the JAX package; both switches are set off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        device = pinned()
    if device is None:
        if os.environ.get("CLIP_GP_TPU_TORCH_FORCE_CPU") == "1":
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda"
        else:
            raise RuntimeError(
                "no CUDA device: the port runs on a GPU; set "
                "CLIP_GP_TPU_TORCH_FORCE_CPU=1 to run on the CPU"
            )
    device = torch.device(device)
    if device.type == "cuda":
        configure_cuda_numerics()
    return device


def device_label(device: Optional[Union[str, torch.device]] = None) -> str:
    """``"cpu"`` when ``device`` resolves to the CPU, else the first card's
    ``"<name>, <power limit>"`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints it (a card may be set below its maximum
    power, and then runs slower)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
