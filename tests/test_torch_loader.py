"""``BatchLoader`` (``clip_gp_tpu_torch/data/pipeline.py``) on its pool of
worker processes:

- its batches are bit-identical to a sequential ``_load_one`` loop over the
  same order and per-item seeds, for the eval transform and the train
  transform (random resized crop, flip) from the global stream or a
  private one, with 0, 1 and 3 workers, shuffled or not, with and without
  ``drop_last``, at a batch size that does not divide the split; an eval
  pass leaves ``random``'s state as it was;
- the pool: three loaders start it once; a loader goes on when another
  grows it; a consumer that stops after one
  batch leaves nothing queued in it; a missing file raises ``OSError`` in
  the consumer and a dead worker ``BrokenProcessPool``, and the next loader
  works; a worker imports neither torch nor the parent's ``__main__``, also
  under an entry script that imports torch first;
- every ``data.decode_batch`` span carries ``images``, ``ready`` and
  ``decode_ms``, and a consumer slower than the decode finds its batches
  ready.
"""

import concurrent.futures
import random
import subprocess
import sys
import textwrap
import time
from concurrent.futures.process import BrokenProcessPool
from pathlib import Path

import numpy as np
import pytest

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
for path in (TESTS, ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from _loader_helpers import Exit, Modules, Slow  # noqa: E402
from clip_gp_tpu_torch.core.config import Config  # noqa: E402
from clip_gp_tpu_torch.data import pipeline  # noqa: E402
from clip_gp_tpu_torch.data.datum import Datum  # noqa: E402
from clip_gp_tpu_torch.data.transforms import build_transform  # noqa: E402
from clip_gp_tpu_torch.runtime import profiling  # noqa: E402

N = 23
WAIT_S = 60.0


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    from PIL import Image

    folder = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    items = []
    for i in range(N):
        h, w = int(rng.integers(36, 64)), int(rng.integers(36, 64))
        path = folder / f"{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path, quality=90)
        items.append(Datum(impath=str(path), label=i % 5, classname=f"c{i % 5}"))
    return items


def _transform(train):
    c = Config()
    c.input.size = (32, 32)
    c.input.interpolation = "bicubic"
    c.input.transforms = ["random_resized_crop", "random_flip", "normalize"]
    return build_transform(c, is_train=train)


def _images(loader):
    return sum(len(b["label"]) for b in loader)


def _sequential(source, tfm, batch_size, shuffle, drop_last, stream):
    """The loader's batches, one item after another in this thread."""
    order = list(range(len(source)))
    if shuffle:
        stream.shuffle(order)
    seeds = [stream.getrandbits(63) for _ in order] if tfm.uses_rng else [0] * len(order)
    n = len(order) // batch_size * batch_size if drop_last else len(order)
    out = []
    for start in range(0, n, batch_size):
        idxs = order[start:start + batch_size]
        out.append((np.stack([pipeline._load_one(source[i], tfm, random.Random(seeds[i]))
                              for i in idxs]),
                    [source[i].label for i in idxs], [source[i].impath for i in idxs]))
    return out


@pytest.mark.parametrize("drop_last", [False, True], ids=["all", "drop_last"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("kind", ["eval", "train", "train_private_rng"])
def test_batches_match_a_sequential_loop(source, kind, workers, shuffle, drop_last):
    tfm = _transform(kind != "eval")
    batch_size = 5  # 23 = 4 x 5 + 3
    random.seed(11)
    private = random.Random(7) if kind == "train_private_rng" else None
    before = random.getstate()
    loader = pipeline.BatchLoader(source, tfm, batch_size, shuffle=shuffle,
                                  drop_last=drop_last, num_workers=workers, rng=private)
    got = list(loader)
    after = random.getstate()
    random.setstate(before)
    ref = _sequential(source, tfm, batch_size, shuffle, drop_last,
                      random.Random(7) if private is not None else random)
    assert len(got) == len(ref) == len(loader) == (4 if drop_last else 5)
    for batch, (img, labels, paths) in zip(got, ref):
        assert batch["img"].dtype == np.uint8 and batch["img"].shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(batch["img"], img)
        assert batch["label"].dtype == np.int32 and list(batch["label"]) == labels
        assert batch["impath"] == paths
        assert batch["classname"] == [f"c{label % 5}" for label in labels]
    # the global stream: untouched by an eval pass in order and by a loader
    # with its own stream; else advanced exactly as the sequential loop did
    if kind == "eval" and not shuffle or private is not None:
        assert after == before
    else:
        assert after == random.getstate()


def test_three_loaders_start_the_pool_once(source):
    pipeline._shutdown()
    pools = []
    for _ in range(3):
        assert len(list(pipeline.BatchLoader(source, _transform(False), 4, num_workers=2))) == 6
        pools.append(pipeline._POOL)
    assert pools[0] is not None and pools[0] is pools[1] is pools[2]


def test_a_loader_goes_on_when_another_grows_the_pool(source):
    pipeline._shutdown()
    small = iter(pipeline.BatchLoader(source, _transform(False), 2, num_workers=1))
    got = [next(small)]
    grown = list(pipeline.BatchLoader(source, _transform(False), 4, num_workers=3))
    assert pipeline._POOL_SIZE == pipeline.pool_workers(3)
    got += list(small)  # its later batches go to the grown pool
    assert _images(got) == _images(grown) == N
    np.testing.assert_array_equal(np.concatenate([b["img"] for b in got]),
                                  np.concatenate([b["img"] for b in grown]))


def test_a_consumer_that_stops_early_leaves_nothing_queued(source, monkeypatch):
    submitted = []
    real_pool = pipeline._pool

    class Recording:
        def __init__(self, pool):
            self.pool = pool

        def submit(self, *args):
            submitted.append(self.pool.submit(*args))
            return submitted[-1]

    monkeypatch.setattr(pipeline, "_pool", lambda workers: Recording(real_pool(workers)))
    workers = pipeline.pool_workers(3)
    batches = iter(pipeline.BatchLoader(source, Slow(0.05), 1, num_workers=3))
    first = next(batches)
    assert first["img"].shape[0] == 1
    assert len(submitted) == 2 * workers < N  # decoded ahead, but bounded
    batches.close()  # what a `break` out of the loop does
    done, running = concurrent.futures.wait(submitted, timeout=WAIT_S)
    assert not running
    assert all(f.cancelled() or f.exception() is None for f in done)
    # the next loader's batches are not queued behind anything
    assert len(list(pipeline.BatchLoader(source, _transform(False), 8, num_workers=3))) == 3


def test_a_missing_file_raises_in_the_consumer(source, tmp_path):
    broken = list(source[:6]) + [Datum(impath=str(tmp_path / "gone.jpg"), label=0)]
    with pytest.raises(OSError):
        list(pipeline.BatchLoader(broken, _transform(False), 2, num_workers=2))
    assert _images(pipeline.BatchLoader(source, _transform(False), 4, num_workers=2)) == N


def test_a_dead_worker_raises_and_the_pool_starts_again(source):
    broken = pipeline._pool(pipeline.pool_workers(2))
    with pytest.raises(BrokenProcessPool):
        list(pipeline.BatchLoader(source[:4], Exit(), 2, num_workers=2))
    assert pipeline._POOL is None
    assert _images(pipeline.BatchLoader(source, _transform(False), 4, num_workers=2)) == N
    assert pipeline._POOL is not None and pipeline._POOL is not broken


def test_a_worker_imports_neither_torch_nor_main(source, tmp_path):
    assert "torch" in sys.modules  # this process has it
    seen = np.concatenate([b["img"] for b in pipeline.BatchLoader(source[:6], Modules(), 1,
                                                                  num_workers=2)])
    assert seen.shape == (6, 1, 1, 3) and not seen.any()
    # an entry script that imports torch before it builds a loader
    script = tmp_path / "entry.py"
    script.write_text(textwrap.dedent(f"""\
        import sys

        import torch  # noqa: F401

        sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]
        from _loader_helpers import Modules
        from clip_gp_tpu_torch.data.datum import Datum
        from clip_gp_tpu_torch.data.pipeline import BatchLoader

        if __name__ == "__main__":
            source = [Datum(impath=p, label=0) for p in sys.argv[1:]]
            loader = BatchLoader(source, Modules(), 1, num_workers=2)
            print(sum(int(b["img"].sum()) for b in loader), len(source))
        """))
    out = subprocess.run([sys.executable, str(script)] + [d.impath for d in source[:4]],
                         capture_output=True, text=True, timeout=WAIT_S, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "4"]


@pytest.mark.parametrize("workers", [0, 2])
def test_decode_batch_spans_say_ready_and_decode_ms(source, workers):
    profiling.reset_phases()
    for batch in pipeline.BatchLoader(source, _transform(False), 4, num_workers=workers):
        time.sleep(0.05)  # a consumer slower than the decode
    spans = sorted((s for s in profiling.spans() if s.name == "data.decode_batch"),
                   key=lambda s: s.start_ns)
    assert [s.attrs["images"] for s in spans] == [4] * 5 + [3]
    for s in spans:
        assert set(s.attrs) == {"images", "ready", "decode_ms"}
        assert isinstance(s.attrs["ready"], bool) and s.attrs["decode_ms"] > 0
    if workers == 0:
        assert not any(s.attrs["ready"] for s in spans)
    else:
        assert all(s.attrs["ready"] for s in spans[1:])
    profiling.reset_phases()
