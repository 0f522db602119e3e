"""Multi-device placement helpers: the port of the JAX package's
``parallel/mesh.py``, with its names.

The workload's natural parallelism: the heavy FLOPs are frozen CLIP feature
extraction, so the batch axis splits over the devices (pure data
parallelism: the towers are frozen, so they need no gradient exchange);
training over cached features replicates the small trainable state, splits
the feature batch, and sums the shards' gradients. Grid trials map onto the
devices as well (``parallel/sweep.py``: ``--group-parallel`` and
``--trial-mesh``).

The JAX package describes placement with a ``Mesh`` and shardings, and XLA
derives the transfers. Here a "mesh" is a list of ``torch.device``s: the
CUDA devices on a GPU host (``core.device.local_devices``), or CPU slots that
a test passes in. A batch splits into contiguous chunks, one per device;
each chunk is issued on its device's copy of the weights. CUDA launches are
asynchronous, so one host thread issues every chunk before any finishes,
and the gather onto the first device waits for them in order.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from clip_gp_tpu_torch.core import device as _device


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is ``cuda:0``, CPU slots are
    all the one CPU)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    return a.type == "cpu" or (a.index or 0) == (b.index or 0)


def _chunk_bounds(n: int, n_devices: int) -> List[tuple]:
    """Contiguous [lo, hi) of a batch of n split over n_devices: chunks of
    ceil(n / n_devices), the last one shorter, none empty."""
    size = -(-n // n_devices)
    return [(lo, min(n, lo + size)) for lo in range(0, n, size)] if n else []


def shard_batch(batch, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A tensor or array as contiguous chunks of its leading axis, chunk i
    on ``devices[i]``."""
    x = torch.as_tensor(batch)
    return [x[lo:hi].to(dev) for (lo, hi), dev in
            zip(_chunk_bounds(int(x.shape[0]), len(devices)), devices)]


def _place(tree, dev: torch.device):
    if isinstance(tree, torch.nn.Module):
        first = next(iter(tree.parameters()), None)
        if first is not None and _same_device(first.device, dev):
            return tree
        return copy.deepcopy(tree).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree if _same_device(tree.device, dev) else tree.to(dev)
    if isinstance(tree, dict):
        return {k: _place(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, dev) for v in tree)
    return tree


def replicate(tree, devices: Sequence[torch.device]) -> List:
    """One copy of ``tree`` (a module, a tensor, or dicts and lists of
    them) per device. Where the tree already lies on a device, that copy is
    the tree itself, so a caller that adopts the replicas holds one copy per
    device."""
    return [_place(tree, dev) for dev in devices]


def extraction_shard_devices() -> Optional[List[torch.device]]:
    """The local devices auto-sharded extraction would run over, or ``None``
    when sharding does not apply. Single source of truth for the gate: the
    feature-cache key tags entries with the device count
    (``feature_cache.cache_key``), so the decision is made before any encode.
    Not applicable when:

    - there are fewer than two local devices (the common one-GPU case);
    - the calling thread has a pinned device (``core.device.pinned_device``:
      the group-parallel sweep dedicates one device per trial-group worker,
      and an encode over every device inside a worker would defeat that);
    - ``torch.distributed`` runs more than one process (each process feeds
      its own loader);
    - ``CLIP_GP_TPU_TORCH_SHARD_EXTRACTION=0``.
    """
    if os.environ.get("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION") == "0":
        return None
    if _device.pinned() is not None:
        return None
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return None
    devices = _device.local_devices()
    if len(devices) < 2:
        return None
    return devices


def maybe_sharded_encode(encode_fn: Callable, module, devices=None):
    """Batch-parallel wrapper for an ``(module, images_u8) -> features``
    encode over the local devices, or ``None`` when sharding does not apply
    (``extraction_shard_devices``).

    The returned callable takes uint8 NHWC images (numpy or a tensor),
    issues contiguous chunks on their devices' replicas of ``module``, and
    returns the features in order on the first device. Extraction is per
    image, so the chunks need no exchange.

    ``devices``: the list a prior ``extraction_shard_devices()`` returned,
    to pin the decision (the trainer snapshots it once so that its
    feature-cache keys describe the encode that ran); by default the gate is
    evaluated now. The callable exposes ``.replicas``, one copy of
    ``module`` per device, the first being ``module`` itself where it lies
    on the first device."""
    if devices is None:
        devices = extraction_shard_devices()
    if devices is None:
        return None
    devices = list(devices)
    replicas = replicate(module, devices)

    def call(images_u8) -> torch.Tensor:
        if isinstance(images_u8, np.ndarray):
            images_u8 = torch.from_numpy(images_u8)
        n = int(images_u8.shape[0])
        outs = [encode_fn(replicas[i], images_u8[lo:hi].to(devices[i]))
                for i, (lo, hi) in enumerate(_chunk_bounds(n, len(devices)))]
        return torch.cat([o.to(devices[0]) for o in outs])

    call.replicas = replicas
    return call


def sharded_train_step(loss_fn: Callable, devices: Sequence[torch.device]):
    """Data-parallel gradient step: ``loss_fn(params, features, labels)``
    returns the mean loss of its batch. The returned
    ``step(params, features, labels) -> (loss, grads)`` copies ``params`` (a
    dict of tensors) to every device, splits the batch into contiguous
    chunks, weighs chunk i's loss by n_i / n so that the sum is the
    full-batch mean, and sums the per-shard gradients onto the first device.
    The caller applies its optimizer to ``grads``."""
    devices = list(devices)

    def step(params, features, labels):
        n = int(features.shape[0])
        f_chunks = shard_batch(features, devices)
        l_chunks = shard_batch(labels, devices)
        total = None
        grads = {k: None for k in params}
        for dev, f, lab in zip(devices, f_chunks, l_chunks):
            local = {k: v.detach().to(dev).requires_grad_(True)
                     for k, v in params.items()}
            loss = loss_fn(local, f, lab) * (int(f.shape[0]) / n)
            loss.backward()
            loss = loss.detach().to(devices[0])
            total = loss if total is None else total + loss
            for k, v in local.items():
                g = v.grad.to(devices[0])
                grads[k] = g if grads[k] is None else grads[k] + g
        return total, grads

    return step
