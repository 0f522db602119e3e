"""Whole GP runs through the port's trial-batched runner and the JAX
package's ``run_vmapped_trials``, the port fed the JAX runner's own normal
draws (``jax_draws`` replays its key streams): the Adapter + GP with an lr
grid on the trial axis, and CLIP-Adapter, TaskRes and Tip-Adapter-F on
their GP pre-stage. Top-1 equal per trial, every metric and the zero-shot
block within 1e-3."""

import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

from clip_gp_tpu_torch.core.config import Config as TConfig  # noqa: E402
from test_torch_trial_vmap import (  # noqa: E402
    N_CLASSES,
    SEEDS,
    make_config,
    run_both,
    weights,  # noqa: F401  (the module fixture)
)
from test_torch_trial_vmap_gp import jax_draws  # noqa: E402

METRIC_TOL = 1e-3


GP_RUNS = {
    "adapter-gp-lr-grid": ("Adapter", {"use_gp": True}, [{"lr": 0.01}, {"lr": 0.1}]),
    "clip-adapter-gp": ("CLIP-Adapter", {"use_gp": True}, None),
    "taskres-gp": ("TaskRes", {"use_gp": True}, None),
    "tip-adapter-f-gp": ("Tip-Adapter", {"use_gp": True}, None),
}


@pytest.mark.parametrize("method,adapter,overrides", list(GP_RUNS.values()), ids=list(GP_RUNS))
def test_gp_run_matches_jax_with_its_draws(tmp_path, weights, monkeypatch,  # noqa: F811
                                           method, adapter, overrides):
    from clip_gp_tpu_torch.parallel import trial_vmap as ttv

    config = make_config(TConfig, tmp_path, weights, method, **adapter)
    n_batches = len(range(0, 2 * N_CLASSES, config.dataloader.batch_size_train))
    draws = jax_draws(SEEDS, n_batches=n_batches, epochs=3,
                      prestage_epochs=int(config.optim.max_epoch))
    run = ttv.run_vmapped_trials

    def with_draws(*args, **kwargs):
        return run(*args, draws=draws, **kwargs)

    monkeypatch.setattr(ttv, "run_vmapped_trials", with_draws)
    runs = run_both(tmp_path, weights, method, overrides=overrides, **adapter)
    for t, (j, p) in enumerate(zip(runs["jax"][0], runs["port"][0])):
        assert p["metrics"]["top1_acc"] == j["metrics"]["top1_acc"], (t, j, p)
        for key in ("ece", "aece") + (("macro_f1",) if "macro_f1" in j["metrics"] else ()):
            assert p["metrics"][key] == pytest.approx(j["metrics"][key], abs=METRIC_TOL), key
        for key in ("top1_acc", "ece", "aece"):
            assert p["zero_shot"][key] == pytest.approx(j["zero_shot"][key],
                                                        abs=METRIC_TOL), key
