"""``TRAIN.ENABLE_TENSORBOARD`` in the port against the JAX package.

With tensorboardX present, one CLI run per package (the Adapter without the
GP, deterministic, 2 epochs of 2 batches) writes event files under
``<output_dir>/tensorboard`` with the same scalar tags at the same steps:
``train/loss`` and ``train/lr`` every step, and ``test/<metric>`` once.
The values agree as the runs do: lr equal, loss within 1e-5, the test
metrics within 1e-3 (percentage points). Each trainer closes its writer in
``after_train``. With tensorboardX's import made to fail, the port prints
the JAX package's line, writes no events and finishes the run.
"""

import json
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import tensorboardX  # noqa: E402
from tensorboard.backend.event_processing.event_accumulator import (  # noqa: E402
    EventAccumulator,
)

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402


def _argv(root, out, weights):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "4", "--num-templates", "2",
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights),
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "2",
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "100",
        "TRAIN.ENABLE_TENSORBOARD", "True",
    ]


def _scalars(out):
    acc = EventAccumulator(str(out / "tensorboard"))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("tb")
    weights = base / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        yield {"base": base, "weights": weights, "mp": mp}


@pytest.fixture(scope="module")
def runs(env):
    closed = []

    class Writer(tensorboardX.SummaryWriter):
        def close(self):
            closed.append(self.logdir)
            super().close()

    env["mp"].setattr(tensorboardX, "SummaryWriter", Writer)
    out = {}
    for side, cli, reset in (("jax", jax_cli, jax_reset_tee),
                             ("port", port_cli, port_reset_tee)):
        run = env["base"] / side
        try:
            cli.main(_argv(env["base"] / f"data-{side}", run, env["weights"]))
        finally:
            reset()
        out[side] = _scalars(run)
    env["mp"].undo()
    env["mp"].setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    out["closed"] = closed
    return out


def test_same_tags_and_steps_as_jax(runs):
    jax_tb, port_tb = runs["jax"], runs["port"]
    assert sorted(port_tb) == sorted(jax_tb)
    assert {"train/loss", "train/lr", "test/top1_acc", "test/ece"} <= set(port_tb)
    for tag in jax_tb:
        assert [s for s, _ in port_tb[tag]] == [s for s, _ in jax_tb[tag]], tag
    assert [s for s, _ in port_tb["train/loss"]] == [0, 1, 2, 3]


def test_same_values_as_jax(runs):
    for tag, events in runs["jax"].items():
        got = [v for _, v in runs["port"][tag]]
        want = [v for _, v in events]
        tol = 1e-5 if tag.startswith("train/") else 1e-3
        assert got == pytest.approx(want, abs=tol, rel=0), tag


def test_writer_closed_in_after_train(runs, env):
    assert sorted(runs["closed"]) == sorted(
        str(env["base"] / side / "tensorboard") for side in ("jax", "port"))


def test_without_tensorboardx_the_run_finishes(env):
    env["mp"].setitem(sys.modules, "tensorboardX", None)
    run = env["base"] / "no-tbx"
    try:
        port_cli.main(_argv(env["base"] / "data-port", run, env["weights"]))
    finally:
        port_reset_tee()
        env["mp"].delitem(sys.modules, "tensorboardX")
        sys.modules["tensorboardX"] = tensorboardX
    assert "tensorboardX unavailable; scalar logging disabled" in (run / "log.txt").read_text()
    assert not any((run / "tensorboard").iterdir())
    metrics = json.loads((run / "metrics.json").read_text())["metrics"]
    assert metrics["top1_acc"] >= 0
