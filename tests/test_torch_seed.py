"""A negative run seed, in the port as in the JAX package.

The JAX package takes any int seed: ``train.py --seed -1`` skips host seeding
and ``jax.random.key(-1)`` is valid. The port's ``KeySequence`` must take the
same seeds (numpy's ``SeedSequence`` takes only non-negative entropy), and
its CLI must finish a run with ``--seed -1``.
"""

import json

import numpy as np
import pytest
import torch

from clip_gp_tpu_torch import train as port_cli
from clip_gp_tpu_torch.core import seeding as tseed
from clip_gp_tpu_torch.core.logging import reset_tee


@pytest.mark.parametrize("seed", [-1, -(2**63), 2**63, 2**64 - 2])
def test_key_sequence_takes_any_int64_or_uint64_seed(seed):
    g = tseed.KeySequence(seed, "cpu").next()
    assert torch.isfinite(torch.randn(4, generator=g)).all()


def test_distinct_seeds_give_distinct_streams():
    draws = {seed: torch.randn(4, generator=tseed.KeySequence(seed, "cpu").next())
             for seed in (-2, -1, 0, 1, 2**63)}
    values = list(draws.values())
    for i in range(len(values)):
        for j in range(i + 1, len(values)):
            assert not torch.equal(values[i], values[j])
    # a non-negative seed keeps the stream it had before negative seeds
    # were taken
    child = np.random.SeedSequence(1).spawn(1)[0]
    ref = torch.Generator().manual_seed(
        int(child.generate_state(1, dtype=np.uint64)[0] >> 1))
    torch.testing.assert_close(draws[1], torch.randn(4, generator=ref),
                               rtol=0, atol=0)


def test_cli_finishes_with_a_negative_seed(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    out = tmp_path / "run"
    try:
        port_cli.main([
            "--dataset", "Synthetic", "--root", str(tmp_path / "data"),
            "--shots", "2", "--backbone", "TEST-ViT", "--seed", "-1",
            "--output-dir", str(out), "--batch-size", "8",
            "--num-templates", "2",
            "INPUT.SIZE", "(32, 32)", "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "1",
            "DATALOADER.NUM_WORKERS", "0",
        ])
    finally:
        reset_tee()
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["config"]["seed"] == -1
    assert 0.0 <= metrics["metrics"]["top1_acc"] <= 100.0
