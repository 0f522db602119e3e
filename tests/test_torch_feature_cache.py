"""The port's feature cache (``runtime/feature_cache.py``) and its use by
``BaseTrainer.encode_images_batched`` against the JAX package's.

- Keys: the port's key is the JAX package's ``cache_key(...)`` for the same
  config, split and weights tag, then ``_torch-<device type>``, for the
  fp32 and the int8 tower (the port's one int8 tower takes JAX's ``int8``
  label, never ``int8xla``); a trainer's key records the tower it really
  runs.
- ``store``/``load`` round-trip; the memo holds numpy arrays only.
- A second trainer (a fresh memo, the disk cache warm) loads the test
  split's features without calling the image tower, bit for bit equal to
  the first trainer's encode, while the train split still runs the tower.
- ``CLIP_GP_TPU_TORCH_EXTRACT_DEVICE_BATCH`` changes how many images each
  tower call takes, not the features (equal bit for bit).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import clip_gp_tpu_torch.data.datasets  # noqa: E402,F401
import clip_gp_tpu_torch.methods  # noqa: E402,F401
from clip_gp_tpu.core.config import parse_args_to_config as jax_parse  # noqa: E402
from clip_gp_tpu.data.datum import Datum as JaxDatum  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu.runtime import feature_cache as jax_cache  # noqa: E402
from clip_gp_tpu_torch.core.config import parse_args_to_config  # noqa: E402
from clip_gp_tpu_torch.core.registry import build_trainer  # noqa: E402
from clip_gp_tpu_torch.core.seeding import set_random_seed  # noqa: E402
from clip_gp_tpu_torch.data.datum import Datum  # noqa: E402
from clip_gp_tpu_torch.data.pipeline import build_data_manager  # noqa: E402
from clip_gp_tpu_torch.methods import common  # noqa: E402
from clip_gp_tpu_torch.runtime import feature_cache  # noqa: E402


def _argv(root, out, weights, extra=()):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "2",
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights), "DATALOADER.NUM_WORKERS", "0",
        *extra,
    ]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("cache")
    weights = base / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        mp.setenv("CLIP_GP_TPU_TORCH_FEATURE_CACHE", str(base / "features"))
        yield {"base": base, "weights": weights, "mp": mp}


def _trainer(env, extra=()):
    config = parse_args_to_config(_argv(env["base"] / "data", env["base"] / "out",
                                        env["weights"], extra))
    set_random_seed(config.seed)
    trainer = build_trainer(config, build_data_manager(config))
    trainer.build_model()
    calls = []
    encode = trainer.clip_model.encode_image

    def counted(x, *args, **kwargs):
        calls.append(x.shape[0])
        return encode(x, *args, **kwargs)

    trainer.clip_model.encode_image = counted
    return trainer, calls


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_key_is_the_jax_key_and_the_torch_tag(tmp_path, int8):
    argv = _argv(tmp_path, tmp_path / "out", tmp_path / "w.npz")
    if int8:
        argv += ["MODEL.INT8_INFERENCE", "True"]
    items = [(f"{tmp_path}/img_{i}.png", i % 3) for i in range(7)]
    want = jax_cache.cache_key(jax_parse(argv), [JaxDatum(p, y) for p, y in items],
                               "rand1", int8=int8, int8_fused=True)
    for device_type in ("cpu", "cuda"):
        got = feature_cache.cache_key(parse_args_to_config(argv),
                                      [Datum(p, y) for p, y in items], "rand1",
                                      device_type=device_type, int8=int8)
        assert got == f"{want}_torch-{device_type}"
    assert ("_int8_" in got) == int8 and "int8xla" not in got


def test_store_load_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FEATURE_CACHE", str(tmp_path))
    labels = np.arange(5, dtype=np.int64)
    feats = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    assert feature_cache.load("k") is None
    feature_cache.store("k", labels, feats)
    got_labels, got_feats = feature_cache.load("k")
    np.testing.assert_array_equal(got_labels, labels)
    np.testing.assert_array_equal(got_feats, feats)
    assert got_feats.dtype == np.float32
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FEATURE_CACHE", "1")
    assert feature_cache.cache_dir() == Path.home() / ".cache" / "clip_gp_tpu_torch" / "features"
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_FEATURE_CACHE")
    assert feature_cache.cache_dir() is None and feature_cache.load("k") is None


def test_memo_holds_host_arrays_only():
    with pytest.raises(TypeError):
        feature_cache.memo_put("t", np.zeros(2), torch.zeros(2, 3))


def test_second_trainer_hits_without_the_tower(env, capsys):
    feature_cache.memo_clear()
    first, first_calls = _trainer(env)
    labels, feats = first.encode_images_batched(first.test_loader, cacheable=True)
    assert sum(first_calls) == len(labels) == 24
    stored = [p for p in (env["base"] / "features").glob("*_torch-cpu.npz")
              if "_int8_" not in p.name]
    assert len(stored) == 1

    feature_cache.memo_clear()  # a new process: only the disk cache is warm
    second, calls = _trainer(env)
    capsys.readouterr()
    got_labels, got_feats = second.encode_images_batched(second.test_loader, cacheable=True)
    assert calls == []
    assert "[feature-cache] hit" in capsys.readouterr().out
    np.testing.assert_array_equal(got_labels, labels)
    np.testing.assert_array_equal(got_feats, feats)
    # the same trainer again: the memo answers
    second.encode_images_batched(second.test_loader, cacheable=True)
    assert calls == [] and "memo hit" in capsys.readouterr().out
    # the train split is never cached
    second.encode_images_batched(second.train_loader_x)
    assert sum(calls) == len(second.dm.dataset.train_x)


def test_trainer_key_records_the_int8_tower(env):
    feature_cache.memo_clear()
    trainer, calls = _trainer(env, ["MODEL.INT8_INFERENCE", "True"])
    trainer.encode_images_batched(trainer.test_loader, cacheable=True)
    assert calls == []  # the int8 tower encodes, not the fp32 one
    assert list((env["base"] / "features").glob("*_int8_torch-cpu.npz"))


def test_extract_device_batch_groups_without_changing_features(env):
    trainer, calls = _trainer(env)
    assert common.extract_device_batch() == 512
    _, whole = trainer.encode_images_batched(trainer.test_loader)
    assert calls == [24]
    calls.clear()
    env["mp"].setenv("CLIP_GP_TPU_TORCH_EXTRACT_DEVICE_BATCH", "8")
    try:
        _, grouped = trainer.encode_images_batched(trainer.test_loader)
    finally:
        env["mp"].delenv("CLIP_GP_TPU_TORCH_EXTRACT_DEVICE_BATCH")
    assert calls == [8, 8, 8]
    np.testing.assert_array_equal(grouped, whole)
