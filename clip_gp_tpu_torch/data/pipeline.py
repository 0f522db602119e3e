"""Host batch pipeline: threaded decode/augment feeding uint8 batches.

Replaces torch DataLoader worker processes (ref: utils/data_manager.py:62-83)
with a thread-pool prefetcher: PIL decode releases the GIL, batches are
assembled into numpy arrays, and the device sees one uint8 NHWC array per
batch (normalization happens on device, see transforms.py). Pillow is
imported at the first decode, not with the module.
"""

from __future__ import annotations

import concurrent.futures
import os
import random
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


class BatchLoader:
    """Iterable over dict batches {img: uint8 [B,H,W,3], label: int32 [B], ...}."""

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
        self.num_workers = max(1, num_workers)
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
        # from the (run-seeded) stream BEFORE threading — worker-thread
        # interleaving can no longer change augmentation draws between runs.
        # Deterministic transforms (uses_rng=False: the eval/test path) draw
        # NOTHING: in the reference, evaluation never consumes python
        # `random`, so an extra eval pass must not shift later training
        # augmentation draws (found in review, 2026-08-18).
        if getattr(self.transform, "uses_rng", True):
            item_seeds = [src.getrandbits(63) for _ in order]
        else:
            item_seeds = [0] * len(order)
        n_batches = len(self)
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            for b in range(n_batches):
                idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
                # on the thread that iterates: the span closes before the
                # batch is handed over
                with span("data.decode_batch", images=len(idxs)):
                    items = [self.data_source[i] for i in idxs]
                    rngs = [random.Random(item_seeds[i]) for i in idxs]
                    images = list(
                        pool.map(
                            lambda args: _load_one(args[0], self.transform, args[1]),
                            zip(items, rngs),
                        )
                    )
                    batch = {
                        "img": np.stack(images),
                        "label": np.asarray([it.label for it in items], dtype=np.int32),
                        "impath": [it.impath for it in items],
                        "classname": [it.classname for it in items],
                    }
                yield batch


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
