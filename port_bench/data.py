"""The benchmark's image data: a tree in Caltech101's layout and a folder
of images to serve, generated from a fixed data seed into a fixed directory
of the checkout (``build/port_bench/data``), once: a later run finds the
marker that names the parameters and generates nothing.

The images are synthetic: class c is a sinusoid of its own frequency,
orientation and colour, with per-image phase and pixel noise (after the
port's ``data/datasets/synthetic.py``), saved as JPEG at the traffic's size.
The Caltech101 tree holds ``101_ObjectCategories/<class>/image_NNNN.jpg``
and CoOp's ``split_zhou_Caltech101.json`` with the split's sizes spread as
evenly over the classes as the totals allow.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "build" / "port_bench" / "data"

# Caltech101's categories without BACKGROUND_Google and Faces_easy, as the
# CoOp split names them
CALTECH101 = (
    "face leopard motorbike accordion airplane anchor ant barrel bass beaver "
    "binocular bonsai brain brontosaurus buddha butterfly camera cannon car_side "
    "ceiling_fan cellphone chair chandelier cougar_body cougar_face crab crayfish "
    "crocodile crocodile_head cup dalmatian dollar_bill dolphin dragonfly "
    "electric_guitar elephant emu euphonium ewer ferry flamingo flamingo_head "
    "garfield gerenuk gramophone grand_piano hawksbill headphone hedgehog "
    "helicopter ibis inline_skate joshua_tree kangaroo ketch lamp laptop llama "
    "lobster lotus mandolin mayfly menorah metronome minaret nautilus octopus "
    "okapi pagoda panda pigeon pizza platypus pyramid revolver rhino rooster "
    "saxophone schooner scissors scorpion sea_horse snoopy soccer_ball stapler "
    "starfish stegosaurus stop_sign strawberry sunflower tick trilobite umbrella "
    "watch water_lilly wheelchair wild_cat windsor_chair wrench yin_yang"
).split()


def classnames(n: int) -> List[str]:
    if n > len(CALTECH101):
        raise ValueError(f"{n} classes asked, {len(CALTECH101)} named")
    return [c.replace("_", " ") for c in CALTECH101[:n]]


def image(cls: int, index: int, size: int, seed: int) -> np.ndarray:
    """uint8 [size, size, 3] image ``index`` of class ``cls``."""
    rng = np.random.default_rng([seed, cls, index])
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    angle = np.pi * (cls % 8) / 8
    freq = 1 + (cls // 8) % 13
    wave = np.sin(2 * np.pi * freq * (xx * np.cos(angle) + yy * np.sin(angle))
                  + rng.uniform(0, 2 * np.pi))
    colour = np.array([(cls * 37) % 256, (cls * 91) % 256, (cls * 53) % 256], np.float32)
    img = colour * (0.6 + 0.4 * wave[..., None]) + rng.normal(0, 20, (size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _spread(total: int, parts: int) -> List[int]:
    return [total // parts + (1 if i < total % parts else 0) for i in range(parts)]


def _marker(kind: str, spec: Dict) -> str:
    return ".done-" + hashlib.sha256(json.dumps([kind, spec], sort_keys=True).encode()).hexdigest()[:16]


def _write(jobs: List[Tuple[Path, int, int]], size: int, seed: int) -> None:
    from PIL import Image

    def one(job):
        path, cls, index = job
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(image(cls, index, size, seed)).save(path, quality=90)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        list(pool.map(one, jobs))


def _generate(kind: str, spec: Dict, build) -> Path:
    """The directory of ``kind`` for ``spec``, generated by ``build(tmp)``
    into a temporary sibling and renamed into place."""
    target = DATA / f"{kind}-{_marker(kind, spec)[6:]}"
    if (target / _marker(kind, spec)).exists():
        return target
    tmp = target.with_name(target.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(target, ignore_errors=True)
    tmp.mkdir(parents=True)
    build(tmp)
    (tmp / _marker(kind, spec)).write_text(json.dumps(spec))
    tmp.rename(target)
    return target


def caltech_tree(spec: Dict) -> Path:
    """The dataset root holding ``caltech-101/`` for the traffic's
    ``dataset`` entry: classes, train/val/test totals, image size, seed."""
    k = spec["classes"]
    names = CALTECH101[:k]
    counts = [_spread(spec[part], k) for part in ("train", "val", "test")]

    def build(tmp: Path):
        base = tmp / "caltech-101"
        split = {"train": [], "val": [], "test": []}
        jobs = []
        for c, name in enumerate(names):
            index = 0
            for part, per_class in zip(("train", "val", "test"), counts):
                for _ in range(per_class[c]):
                    rel = f"{name}/image_{index + 1:04d}.jpg"
                    split[part].append([rel, c, name.replace("_", " ")])
                    jobs.append((base / "101_ObjectCategories" / rel, c, index))
                    index += 1
        _write(jobs, spec["image_size"], spec["seed"])
        (base / "split_zhou_Caltech101.json").write_text(json.dumps(split))

    return _generate("caltech101", spec, build)


def image_folder(spec: Dict) -> Path:
    """A folder of ``images`` JPEGs, in one sub-folder per class."""
    k = spec["classes"]
    per_class = _spread(spec["images"], k)

    def build(tmp: Path):
        _write([(tmp / CALTECH101[c] / f"img_{i:05d}.jpg", c, 100_000 + i)
                for c in range(k) for i in range(per_class[c])],
               spec["image_size"], spec["seed"])

    return _generate("folder", spec, build)
