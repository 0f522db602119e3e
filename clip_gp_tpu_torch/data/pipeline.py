"""Host batch pipeline: decode/augment in worker processes, uint8 batches out.

Like torch DataLoader's worker processes (ref: utils/data_manager.py:62-83),
``BatchLoader`` decodes in processes: Pillow holds the interpreter lock for
most of an image's work (parsing the markers, convert, crop, the copy into
numpy), so threads decode little faster than one. One pool of workers per
process (``_pool``) serves every loader: it starts at the first loader that
needs it, with the ``forkserver`` start method and only this module
preloaded, so a process that has initialised CUDA and runs threads is never
forked, and a worker imports neither the parent's ``__main__`` nor torch.
A worker decodes a whole batch into one uint8 NHWC array and returns it
through the pool's pipe; a loader keeps up to two batches per worker in
flight and hands them over in order. ``num_workers=0`` decodes in the
calling thread. Normalization happens on the device (transforms.py).
Pillow is imported at the first decode, not with the module.
"""

from __future__ import annotations

import atexit
import collections
import concurrent.futures
import io
import itertools
import multiprocessing.context
import os
import random
import threading
import time
from concurrent.futures.process import BrokenProcessPool
from multiprocessing import forkserver, popen_forkserver, reduction, spawn, util
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from clip_gp_tpu_torch.data.datum import Datum

# Opt-in native fused JPEG decode->resize->crop (clip_gp_tpu_torch/native;
# within a few gray levels of the PIL bicubic path). Needs g++ and libjpeg's
# headers and library; without them every image takes the PIL path.
_USE_NATIVE = os.environ.get("CLIP_GP_TPU_TORCH_NATIVE_DECODE") == "1"


def _load_one(item: Datum, transform, rng=None) -> np.ndarray:
    from PIL import Image, ImageFile

    # tolerate truncated files like the reference (ref: train.py:32-33)
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    is_jpeg = item.impath.lower().endswith((".jpg", ".jpeg"))
    target = getattr(transform, "native_target", None)
    if _USE_NATIVE and target is not None and is_jpeg:
        from clip_gp_tpu_torch.native import decode_resize_crop

        try:
            with open(item.impath, "rb") as f:
                out = decode_resize_crop(f.read(), target)
            if out is not None:
                return out
        except OSError:
            pass
    rrc = getattr(transform, "native_rrc", None)
    if _USE_NATIVE and rrc is not None and is_jpeg and rng is not None:
        # train path: decode + RandomResizedCrop window + flip in one native
        # pass; the window/flip are sampled HERE with the per-item rng (the
        # same draws, in the same order, as the PIL path), and a decode
        # failure falls back to PIL with the ALREADY-sampled window so the
        # RNG stream never desynchronizes
        from clip_gp_tpu_torch.data.transforms import sample_rrc_box
        from clip_gp_tpu_torch.native import decode_rrc, jpeg_dims

        try:
            with open(item.impath, "rb") as f:
                data = f.read()
        except OSError:
            data = None
        if data is not None:
            dims = jpeg_dims(data)
            if dims is not None:
                t = rrc["target"]
                x, y, w, h = sample_rrc_box(dims[0], dims[1], rng=rng)
                flip = rrc["flip"] and rng.random() < 0.5
                out = decode_rrc(data, (x, y, w, h), t, flip)
                if out is not None:
                    return out
                img = Image.open(item.impath).convert("RGB")
                # crop-then-resize like torchvision (see transforms.py)
                img = img.crop((x, y, x + w, y + h)).resize(
                    (t, t), Image.BICUBIC)
                if flip:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
                return np.asarray(img, dtype=np.uint8)
    img = Image.open(item.impath).convert("RGB")
    if rng is not None:
        return transform(img, rng=rng)
    return transform(img)


def _decode_batch(paths: List[str], seeds: List[int], transform, native: bool):
    """One loader batch, in a worker (or inline): (uint8 [B, H, W, 3], the
    decode's milliseconds). Each item's augmentation draws come from its own
    ``random.Random(seed)``, so they do not depend on which worker runs it;
    ``native`` is the loader's ``_USE_NATIVE``."""
    global _USE_NATIVE
    _USE_NATIVE = native
    start = time.perf_counter()
    images = np.stack([_load_one(Datum(impath=p, label=-1), transform, random.Random(s))
                       for p, s in zip(paths, seeds)])
    return images, 1e3 * (time.perf_counter() - start)


class _Popen(popen_forkserver.Popen):
    """``forkserver``'s launch, less the instruction to run the parent's
    ``__main__`` in the child: a worker needs only this module, and an
    entry script would import torch (or, without a ``__main__`` guard, run
    itself) in every worker."""

    def _launch(self, process_obj):
        prep = spawn.get_preparation_data(process_obj._name)
        prep.pop("init_main_from_name", None)
        prep.pop("init_main_from_path", None)
        buf = io.BytesIO()
        multiprocessing.context.set_spawning_popen(self)
        try:
            reduction.dump(prep, buf)
            reduction.dump(process_obj, buf)
        finally:
            multiprocessing.context.set_spawning_popen(None)
        self.sentinel, w = forkserver.connect_to_new_process(self._fds)
        # kept open as the child's sentinel of its parent, as the stock launch does
        parent_w = os.dup(w)
        self.finalizer = util.Finalize(self, util.close_fds, (parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = forkserver.read_signed(self.sentinel)


class _WorkerProcess(multiprocessing.context.ForkServerProcess):
    @staticmethod
    def _Popen(process_obj):
        return _Popen(process_obj)


class _WorkerContext(multiprocessing.context.ForkServerContext):
    Process = _WorkerProcess


_POOL: Optional[concurrent.futures.ProcessPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def pool_workers(num_workers: int) -> int:
    """The worker processes a loader asked for ``num_workers`` uses: at most
    the usable cores less one, which the launching thread keeps; 0 decodes
    inline."""
    if num_workers <= 0:
        return 0
    return min(num_workers, max(1, len(os.sched_getaffinity(0)) - 1))


def _pool(workers: int) -> concurrent.futures.ProcessPoolExecutor:
    """The process's pool, started (or grown) to at least ``workers``."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE < workers:
            if _POOL is not None:
                _POOL.shutdown(wait=False)  # its queued batches still finish
            ctx = _WorkerContext()
            ctx.set_forkserver_preload([__name__])
            _POOL = concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx)
            _POOL_SIZE = workers
        return _POOL


def _discard(pool) -> None:
    """Drop a broken pool; the next loader starts a new one."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is pool:
            _POOL = None
    pool.shutdown(wait=False, cancel_futures=True)


@atexit.register
def _shutdown() -> None:
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


class BatchLoader:
    """Iterable over dict batches {img: uint8 [B,H,W,3], label: int32 [B], ...}.

    ``num_workers`` worker processes of the shared pool (``pool_workers``)
    decode up to ``2 * workers`` batches ahead of the consumer; 0 decodes
    each batch in the calling thread when it is asked for."""

    def __init__(
        self,
        data_source: List[Datum],
        transform: Callable,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        rng: Optional[random.Random] = None,
    ):
        self.data_source = data_source
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last and len(data_source) >= batch_size
        self.num_workers = num_workers
        # optional private stream: callers that iterate loaders concurrently
        # (the sweep's group-parallel workers) pass their own Random so the
        # shuffle/item-seed draws stay deterministic under any interleaving;
        # default is the run-seeded global stream (reference parity)
        self.rng = rng

    def __len__(self) -> int:
        n = len(self.data_source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        from clip_gp_tpu_torch.runtime.profiling import span

        src = self.rng if self.rng is not None else random
        order = list(range(len(self.data_source)))
        if self.shuffle:
            src.shuffle(order)
        # one deterministic augmentation seed per item, drawn sequentially
        # from the (run-seeded) stream BEFORE any task is sent — which worker
        # decodes an item can no longer change its augmentation draws.
        # Deterministic transforms (uses_rng=False: the eval/test path) draw
        # NOTHING: in the reference, evaluation never consumes python
        # `random`, so an extra eval pass must not shift later training
        # augmentation draws (found in review, 2026-08-18).
        if getattr(self.transform, "uses_rng", True):
            item_seeds = [src.getrandbits(63) for _ in order]
        else:
            item_seeds = [0] * len(order)
        batches = [order[b * self.batch_size : (b + 1) * self.batch_size]
                   for b in range(len(self))]
        tasks = (([self.data_source[i].impath for i in idxs], [item_seeds[i] for i in idxs],
                  self.transform, _USE_NATIVE) for idxs in batches)
        workers = pool_workers(self.num_workers)
        ahead: collections.deque = collections.deque()  # (pool, future), in order
        try:
            for idxs in batches:
                for task in itertools.islice(tasks, 2 * workers - len(ahead)):
                    pool = _pool(workers)
                    ahead.append((pool, pool.submit(_decode_batch, *task)))
                pool, future = ahead.popleft() if workers else (None, None)
                # the hand-over, on the thread that iterates: ``ready`` says
                # whether the batch was decoded before it was asked for,
                # ``decode_ms`` how long its decode took
                with span("data.decode_batch", images=len(idxs),
                          ready=future is not None and future.done()) as handing:
                    if future is None:
                        images, handing.attrs["decode_ms"] = _decode_batch(*next(tasks))
                    else:
                        try:
                            images, handing.attrs["decode_ms"] = future.result()
                        except BrokenProcessPool:
                            _discard(pool)
                            raise
                    items = [self.data_source[i] for i in idxs]
                    batch = {
                        "img": images,
                        "label": np.asarray([it.label for it in items], dtype=np.int32),
                        "impath": [it.impath for it in items],
                        "classname": [it.classname for it in items],
                    }
                yield batch
        finally:
            # a consumer that stops early leaves no batch queued in the pool
            for _, future in ahead:
                future.cancel()


class DataManager:
    """Dataset + loaders + label metadata (ref: utils/data_manager.py:15-95)."""

    def __init__(self, config):
        from clip_gp_tpu_torch.core.registry import build_dataset
        from clip_gp_tpu_torch.data.transforms import build_transform

        self.config = config
        self.dataset = build_dataset(config)
        self.tfm_train = build_transform(config, is_train=True)
        self.tfm_test = build_transform(config, is_train=False)
        workers = config.dataloader.num_workers
        self.train_loader_x: Optional[BatchLoader] = (
            BatchLoader(
                self.dataset.train_x,
                self.tfm_train,
                config.dataloader.batch_size_train,
                shuffle=True,
                drop_last=True,
                num_workers=workers,
            )
            if self.dataset.train_x
            else None
        )
        self.test_loader: Optional[BatchLoader] = (
            BatchLoader(
                self.dataset.test,
                self.tfm_test,
                config.dataloader.batch_size_test,
                num_workers=workers,
            )
            if self.dataset.test
            else None
        )
        self.val_loader: Optional[BatchLoader] = (
            BatchLoader(
                self.dataset.val,
                self.tfm_test,
                config.dataloader.batch_size_test,
                num_workers=workers,
            )
            if self.dataset.val
            else None
        )
        self.num_classes = self.dataset.num_classes
        self.lab2cname = self.dataset.lab2cname
        self._print_info()

    def eval_train_loader(self) -> BatchLoader:
        """Deterministic full pass over train_x with test transforms disabled —
        used for one-time feature extraction (ref: trainers/adapter.py:886-926
        uses the train transform but no shuffling/drop_last)."""
        return BatchLoader(
            self.dataset.train_x,
            self.tfm_train,
            self.config.dataloader.batch_size_train,
            shuffle=False,
            drop_last=False,
            num_workers=self.config.dataloader.num_workers,
        )

    def _print_info(self):
        name = getattr(self.dataset, "dataset_name", type(self.dataset).__name__)
        print("---------  ----------")
        print(f"Dataset    {name}")
        print(f"# classes  {self.num_classes}")
        print(f"# train_x  {len(self.dataset.train_x)}")
        if self.dataset.val:
            print(f"# val      {len(self.dataset.val)}")
        print(f"# test     {len(self.dataset.test)}")
        print("---------  ----------")


def build_data_manager(config) -> DataManager:
    return DataManager(config)
