"""Plain reference of the data path: the few-shot split, the sweep's union
of few-shot images and its augmentation stream, the epoch shuffle, and the
decode and transforms, from the split JSON and the JPEG files that both
sides read.

- few-shot split (CoOp's ``generate_fewshot_dataset``): seed python's
  ``random`` with the trial seed, then per label, in the order labels first
  appear in the split's train list, ``random.sample(items, shots)``;
- a trial group's union: every trial's few-shot items in trial order, each
  image once; its augmentation stream is ``random.Random`` seeded with the
  string ``clip-gp-vmap-aug-<trial seeds joined by ->-<dataset>-<shots>``,
  from which each union item draws ``getrandbits(63)`` in union order, the
  seed of that item's own ``random.Random``;
- train transform (torchvision's ``RandomResizedCrop(224, scale=(0.08, 1),
  ratio=(3/4, 4/3))`` with bicubic resampling, crop first, then
  ``RandomHorizontalFlip``), eval transform (resize of the shorter side to
  224, truncating the longer, then a centre crop);
- epoch shuffle of trial t: ``np.random.default_rng((seed_t, epoch))``.
"""

from __future__ import annotations

import json
import math
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

Item = Tuple[str, int]  # (image path, label)


def read_split(split_json: str, image_dir: str) -> Dict[str, List[Item]]:
    with open(split_json) as f:
        split = json.load(f)
    return {part: [(os.path.join(image_dir, p), int(lab)) for p, lab, _ in rows]
            for part, rows in split.items()}


def fewshot(train: List[Item], seed: int, shots: int) -> List[Item]:
    rng = random.Random(int(seed))
    groups: Dict[int, List[Item]] = {}
    for item in train:
        groups.setdefault(item[1], []).append(item)
    out: List[Item] = []
    for items in groups.values():
        out += rng.sample(items, shots)
    return out


def union(per_trial: Sequence[List[Item]]) -> Tuple[List[Item], np.ndarray]:
    """(union items, [T, N] positions of each trial's items in it)."""
    pos: Dict[str, int] = {}
    items: List[Item] = []
    for trial in per_trial:
        for it in trial:
            if it[0] not in pos:
                pos[it[0]] = len(items)
                items.append(it)
    return items, np.asarray([[pos[it[0]] for it in trial] for trial in per_trial])


def aug_seeds(trial_seeds: Sequence[int], dataset: str, shots: int, n: int) -> List[int]:
    rng = random.Random("clip-gp-vmap-aug-" + "-".join(str(int(s)) for s in trial_seeds)
                        + f"-{dataset}-{shots}")
    return [rng.getrandbits(63) for _ in range(n)]


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    return np.random.default_rng((int(seed), epoch)).permutation(n)


def _rrc_box(width: int, height: int, rng: random.Random):
    area = width * height
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        aspect = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
        w = int(round(math.sqrt(target * aspect)))
        h = int(round(math.sqrt(target / aspect)))
        if 0 < w <= width and 0 < h <= height:
            return rng.randint(0, width - w), rng.randint(0, height - h), w, h
    ratio = width / height
    if ratio < 3 / 4:
        w, h = width, int(round(width / (3 / 4)))
    elif ratio > 4 / 3:
        w, h = int(round(height * (4 / 3))), height
    else:
        w, h = width, height
    return (width - w) // 2, (height - h) // 2, w, h


def load_train(path: str, item_seed: int, size: int = 224) -> np.ndarray:
    from PIL import Image

    rng = random.Random(item_seed)
    img = Image.open(path).convert("RGB")
    x, y, w, h = _rrc_box(img.size[0], img.size[1], rng)
    img = img.crop((x, y, x + w, y + h)).resize((size, size), Image.BICUBIC)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img, dtype=np.uint8)


def load_eval(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    width, height = img.size
    if min(width, height) != size:
        if width <= height:
            img = img.resize((size, int(size * height / width)), Image.BICUBIC)
        else:
            img = img.resize((int(size * width / height), size), Image.BICUBIC)
    width, height = img.size
    x, y = int(round((width - size) / 2.0)), int(round((height - size) / 2.0))
    return np.asarray(img.crop((x, y, x + size, y + size)), dtype=np.uint8)


def load_many(fn, args: Sequence, workers: int = 8) -> np.ndarray:
    with ThreadPoolExecutor(workers) as pool:
        return np.stack(list(pool.map(lambda a: fn(*a), args)))
