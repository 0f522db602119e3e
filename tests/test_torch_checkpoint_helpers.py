"""The port's generic checkpoint helpers (``runtime/checkpoint.py``) and host
RNG-state helpers (``core/seeding.py``) against the JAX package's.

The four cases of ``tests/test_checkpoint_helpers.py`` run on the port, and
the npz layout is shared: a checkpoint saved by either package loads in the
other with every array equal (bit for bit) and the epoch kept. The RNG-state
snapshot covers the host ``random`` and numpy streams, as JAX's does.
"""

import random

import numpy as np
import torch

from clip_gp_tpu.core import seeding as jax_seeding
from clip_gp_tpu.runtime import checkpoint as jax_ckpt
from clip_gp_tpu_torch.core import seeding
from clip_gp_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    load_pretrained_weights,
    resume_from_checkpoint,
    save_checkpoint,
)


def _state():
    rng = np.random.default_rng(0)
    return {
        "visual_proj": rng.normal(size=(4, 4)).astype(np.float32),
        "gp": {"variational_mean": rng.normal(size=(3, 5)).astype(np.float32),
               "tmp_bias": rng.normal(size=(1, 5)).astype(np.float32)},
        "layers": [np.arange(3, dtype=np.int32), np.ones(2, np.float32)],
    }


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def test_roundtrip_suffixless_path(tmp_path):
    state = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "nested": {"b": torch.ones(4)},
    }
    # np.savez appends .npz to suffix-less names; load must still find it
    save_checkpoint(state, str(tmp_path / "model.ckpt-5"), epoch=5)
    loaded, epoch = load_checkpoint(str(tmp_path / "model.ckpt-5"))
    assert epoch == 5
    np.testing.assert_array_equal(loaded["a"], state["a"])
    np.testing.assert_array_equal(loaded["nested"]["b"], np.ones(4, np.float32))


def test_resume_picks_latest_and_tolerates_digitless(tmp_path):
    save_checkpoint({"a": np.zeros(1)}, str(tmp_path / "model.ckpt-2"), epoch=2)
    save_checkpoint({"a": np.ones(1)}, str(tmp_path / "model.ckpt-10"), epoch=10)
    # a hand-named digit-less file must not crash the numeric sort
    save_checkpoint({"a": 2 * np.ones(1)}, str(tmp_path / "model.ckpt-best"))
    state, epoch = resume_from_checkpoint(str(tmp_path))
    assert epoch == 10
    assert float(state["a"][0]) == 1.0


def test_resume_empty_dir(tmp_path):
    assert resume_from_checkpoint(str(tmp_path)) == (None, 0)
    assert resume_from_checkpoint(str(tmp_path / "missing")) == (None, 0)


def test_pretrained_overlay_skips_mismatched(tmp_path, capsys):
    save_checkpoint(
        {"w": np.full((2, 2), 7.0), "extra": np.ones(3)},
        str(tmp_path / "pre.npz"),
    )
    params = {"w": torch.zeros(2, 2, dtype=torch.float64), "other": np.zeros(5)}
    out = load_pretrained_weights(params, str(tmp_path / "pre.npz"))
    np.testing.assert_array_equal(out["w"], np.full((2, 2), 7.0))
    np.testing.assert_array_equal(out["other"], np.zeros(5))
    assert "Skipped 1" in capsys.readouterr().out


def test_jax_save_loads_in_the_port(tmp_path):
    state = _state()
    jax_ckpt.save_checkpoint(state, str(tmp_path / "model.ckpt-3"), epoch=3)
    loaded, epoch = load_checkpoint(str(tmp_path / "model.ckpt-3"))
    assert epoch == 3
    _assert_tree_equal(loaded, state)
    resumed, epoch = resume_from_checkpoint(str(tmp_path))
    assert epoch == 3
    _assert_tree_equal(resumed, state)


def test_port_save_loads_in_jax(tmp_path):
    state = _state()
    tensors = {"visual_proj": torch.from_numpy(state["visual_proj"]),
               "gp": state["gp"], "layers": state["layers"]}
    save_checkpoint(tensors, str(tmp_path / "model.ckpt-4"), epoch=4)
    loaded, epoch = jax_ckpt.load_checkpoint(str(tmp_path / "model.ckpt-4"))
    assert epoch == 4
    _assert_tree_equal(loaded, state)
    overlay = jax_ckpt.load_pretrained_weights(
        {"visual_proj": np.zeros((4, 4), np.float32)}, str(tmp_path / "model.ckpt-4"))
    np.testing.assert_array_equal(overlay["visual_proj"], state["visual_proj"])


def test_random_state_round_trip_matches_jax():
    seeding.set_random_seed(3)
    snap = seeding.get_random_state()
    assert set(snap) == set(jax_seeding.get_random_state()) == {"python", "numpy"}
    first = (random.random(), np.random.rand(3))
    seeding.set_random_state(snap)
    again = (random.random(), np.random.rand(3))
    assert first[0] == again[0]
    np.testing.assert_array_equal(first[1], again[1])
    # a snapshot taken by one package restores in the other
    jax_seeding.set_random_state(snap)
    assert random.random() == first[0]
    np.testing.assert_array_equal(np.random.rand(3), first[1])
