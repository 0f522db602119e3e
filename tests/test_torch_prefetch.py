"""Decode-ahead in the port's sweep (``trial_vmap.DecodePrefetcher`` and the
sequential path of ``sweep.run_trials_vmapped``), the counterparts of the
JAX suite's ``test_decode_prefetcher_propagates_producer_errors``
(``tests/test_trial_vmap.py``) and ``test_decode_prefetch_bit_identical_and_fires``
(``tests/test_sweep_and_aggregate.py``):

- a producer error is raised again in the consumer, by ``wait_splits()``
  (splits) and by ``batches()`` (decode);
- the byte budget bounds the buffer: at 0 MB it holds one batch, at 2.5
  batches' bytes two, while the consumer waits; the batches it hands on are
  the union loader's, augmentation draws included, bit for bit;
- a two-group CPU sweep (the feature-cached Adapter at 1 and 2 shots, 2
  seeds, with augmentation) with decode-ahead, and with a 0 MB budget,
  writes per-trial metrics.json equal to the sweep without it, byte for
  byte once the two wall-clock fields (``timestamp``, ``train_time_s``)
  are set aside; the second group adopts the prefetcher.
"""

import json
import random
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

from test_sweep_and_aggregate import _adapter_two_group_cfg  # noqa: E402
from test_torch_trial_vmap import TConfig, make_config, tcache, ttv, weights  # noqa: E402,F401

import clip_gp_tpu_torch.data.pipeline as pipeline  # noqa: E402
import clip_gp_tpu_torch.parallel.sweep as tsweep  # noqa: E402

WAIT_S = 30.0  # upper bound on any wait for the producer thread


def _config(tmp_path, weights, augment=False):  # noqa: F811
    config = make_config(TConfig, tmp_path / "data", weights, "Adapter")
    config.dataset.num_shots = 4  # a union of up to 32 images, batches of 4
    if augment:
        config.input.transforms = ["random_resized_crop", "random_flip", "normalize"]
    return config


def _until(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "the producer thread did not get there"
        time.sleep(0.01)


def test_producer_errors_reach_the_consumer(tmp_path, weights, monkeypatch):  # noqa: F811
    config = _config(tmp_path, weights)
    pf = ttv.DecodePrefetcher(config, [1, 2], device="cpu")

    def no_splits(needs_val):
        raise RuntimeError("boom-splits")

    monkeypatch.setattr(pf.runner, "_build_per_seed_splits", no_splits)
    pf.start()
    with pytest.raises(RuntimeError, match="boom-splits"):
        pf.wait_splits()

    class ExplodingLoader:
        def __init__(self, *args, **kwargs):
            pass

        def __iter__(self):
            raise RuntimeError("boom-decode")

    monkeypatch.setattr(pipeline, "BatchLoader", ExplodingLoader)
    pf2 = ttv.DecodePrefetcher(config, [1, 2], device="cpu").start()
    assert pf2.wait_splits() is not None  # the sampling itself succeeded
    with pytest.raises(RuntimeError, match="boom-decode"):
        for _ in pf2.batches():
            pass
    for p in (pf, pf2):
        p._thread.join(WAIT_S)
        assert not p._thread.is_alive()


@pytest.mark.parametrize("budget_batches,held", [(0, 1), (2.5, 2)],
                         ids=["0MB-one-batch", "two-batches"])
def test_byte_budget_bounds_the_buffer(tmp_path, weights, monkeypatch,  # noqa: F811
                                       budget_batches, held):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_PREFETCH_BUDGET_MB", "0")
    config = _config(tmp_path, weights, augment=True)
    seeds = [1, 2]
    pf = ttv.DecodePrefetcher(config, seeds, device="cpu")
    assert pf._budget == 0
    batch_bytes = 4 * 32 * 32 * 3  # uint8 NHWC at 32 px
    pf._budget = int(budget_batches * batch_bytes)
    pf.start()
    union, *_, dm = pf.wait_splits()
    n_batches = -(-len(union) // config.dataloader.batch_size_train)
    assert n_batches > held + 1
    _until(lambda: len(pf._batches) == held)
    time.sleep(0.2)  # a producer past its budget would add one by now
    assert len(pf._batches) == held and pf._bytes == held * batch_bytes
    assert pf._thread.is_alive()  # waiting for room, not done
    got = list(pf.batches())
    pf._thread.join(WAIT_S)
    assert not pf._thread.is_alive() and len(got) == n_batches
    # the same batches as the union loader on a fresh runner's stream
    fresh = ttv.VmappedTrials(config, seeds, device="cpu")._aug_rng
    ref = list(pipeline.BatchLoader(union, dm.tfm_train, config.dataloader.batch_size_train,
                                    num_workers=config.dataloader.num_workers, rng=fresh))
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["label"], b["label"])
    assert pf.runner._aug_rng.getstate() == fresh.getstate()


def test_cancel_ends_a_waiting_producer(tmp_path, weights, monkeypatch):  # noqa: F811
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_PREFETCH_BUDGET_MB", "0")
    pf = ttv.DecodePrefetcher(_config(tmp_path, weights), [1, 2], device="cpu").start()
    pf.wait_splits()
    _until(lambda: len(pf._batches) == 1)
    pf.cancel()
    pf._thread.join(WAIT_S)
    assert not pf._thread.is_alive() and pf._batches == []


def _sweep(tmp_path, out_root, monkeypatch, capsys, disable, budget_mb=None):
    if disable:
        monkeypatch.setenv("CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH", "1")
    else:
        monkeypatch.delenv("CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH", raising=False)
    if budget_mb is None:
        monkeypatch.delenv("CLIP_GP_TPU_TORCH_PREFETCH_BUDGET_MB", raising=False)
    else:
        monkeypatch.setenv("CLIP_GP_TPU_TORCH_PREFETCH_BUDGET_MB", str(budget_mb))
    shutil.rmtree(out_root, ignore_errors=True)
    made = []
    real = ttv.DecodePrefetcher

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(ttv, "DecodePrefetcher", recording)
    tcache.memo_clear()
    capsys.readouterr()
    trials, _ = tsweep.build_trials(_adapter_two_group_cfg(tmp_path, out_root))
    assert len(trials) == 4  # 2 shot counts x 2 seeds: two groups
    results = tsweep.run_trials_vmapped(trials, strict=True)
    assert [r["backend"] for r in results] == ["vmap"] * 4
    out = capsys.readouterr().out
    payloads = {}
    for t in trials:
        payload = json.loads((t.format_outdir() / "metrics.json").read_text())
        for volatile in ("timestamp", "train_time_s"):
            payload.pop(volatile)
        payloads[(t.shots, t.seed)] = json.dumps(payload, indent=2)
    return payloads, out, made


def test_sweep_with_decode_ahead_writes_the_same_metrics(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    out_root = tmp_path / "out"
    seq, out, made = _sweep(tmp_path, out_root, monkeypatch, capsys, disable=True)
    assert "decode-ahead" not in out and made == []
    ahead, out, made = _sweep(tmp_path, out_root, monkeypatch, capsys, disable=False)
    assert "[vmap] decode-ahead: prefetching group 2/2" in out
    assert len(made) == 1 and made[0].consumed
    assert ahead == seq
    tiny, out, made = _sweep(tmp_path, out_root, monkeypatch, capsys, disable=False,
                             budget_mb=0)
    assert len(made) == 1 and made[0].consumed
    assert tiny == seq
