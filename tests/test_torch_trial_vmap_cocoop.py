"""CoCoOp on the port's trial axis (``trial_specs.CoCoOpSpec``) against the
JAX package's ``run_vmapped_trials(method="Adapter-CoCoOp")`` on the same
config, seeds, weights (one TEST-ViT npz) and initial state (the JAX
spec's draws, recorded and fed through ``initial_state``), Synthetic with
no augmentation, T=2:

- ``PROMPT_BUDGET`` forced to 3 prompts in both packages'
  ``methods.cocoop``: with K=4 every chunk is one image, whose 4 prompts
  pass the budget, so the image chunks and the prompt sub-slices both run.
  Top-1 equal, ECE/AECE/macro-F1 within 5e-3 and each trial's checkpoint
  within 1e-4 (``test_torch_trial_vmap.assert_same_trials``);
  ``zero_shot`` is null on both sides.
- A trial against the port's in-process ``Adapter-CoCoOp`` trainer of the
  same seed (one batch per epoch, so both see the same images): the same
  initial state, top-1 equal, metrics within 1e-4.
- Image micro-slices (``CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS``) against
  the unsplit step: every parameter within 1e-6.
- The micro-slice sizing and its divisor snap against the JAX package's
  ``cocoop_microbatch_images`` and ``_divisor_le``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

from test_torch_trial_vmap import (  # noqa: E402
    JConfig,
    TConfig,
    assert_same_trials,
    jtv,
    make_config,
    tcache,
    jcache,
    ttv,
    weights,  # noqa: F401  (fixture)
)
from clip_gp_tpu.methods import cocoop as jcocoop  # noqa: E402
from clip_gp_tpu_torch.methods import cocoop as tcocoop  # noqa: E402
from clip_gp_tpu_torch.parallel import trial_specs  # noqa: E402

METHOD = "Adapter-CoCoOp"
SEEDS = [1, 2]
# a trial alone against its in-process run, and micro-slices against the
# unsplit step: the same fp32 math in another order
INPROCESS_TOL = 1e-4
MICRO_TOL = 1e-6


def _stack_states(states, seeds):
    """{seed: single-trial JAX tree} → one tree of [T, ...] numpy arrays."""
    first = states[seeds[0]]
    return {k: ({n: np.stack([np.asarray(states[s][k][n]) for s in seeds]) for n in v}
                if isinstance(v, dict) else np.stack([np.asarray(states[s][k]) for s in seeds]))
            for k, v in first.items()}


def _ckpts(outdirs):
    out = []
    for d in outdirs:
        files = sorted((d / "adapter").glob("model.ckpt-*.npz"))
        out.append(dict(np.load(files[-1])))
    return out


def test_cocoop_group_matches_jax_runner_chunked(tmp_path, weights, monkeypatch):  # noqa: F811
    monkeypatch.setattr(jcocoop, "PROMPT_BUDGET", 3)
    monkeypatch.setattr(tcocoop, "PROMPT_BUDGET", 3)
    states = {}
    init = jtv.CoCoOpSpec.init_params

    def record(spec, seed):
        states[seed] = init(spec, seed)
        return states[seed]

    monkeypatch.setattr(jtv.CoCoOpSpec, "init_params", record)
    runs = {}
    for side, cls, run, cache in (("jax", JConfig, jtv.run_vmapped_trials, jcache),
                                  ("port", TConfig, ttv.run_vmapped_trials, tcache)):
        config = make_config(cls, tmp_path / f"data-{side}", weights, METHOD)
        outdirs = [tmp_path / side / f"t{i}" for i in range(len(SEEDS))]
        kwargs = ({"device": "cpu", "initial_state": _stack_states(states, SEEDS)}
                  if side == "port" else {})
        cache.memo_clear()
        results = run(config, SEEDS, outdirs, method=METHOD, **kwargs)
        runs[side] = (results, _ckpts(outdirs), outdirs)
    assert_same_trials(runs, METHOD)
    for results, _, outdirs in runs.values():
        for d in outdirs:
            assert json.loads((d / "metrics.json").read_text())["zero_shot"] is None
    # the trials trained apart: each trial's context moved its own way
    (_, [c0, c1], _) = runs["port"]
    assert not np.allclose(c0["state/ctx"], c1["state/ctx"])
    assert set(c0) >= {"state/ctx", "state/meta_fc1/w", "state/meta_fc2/b"}


def test_cocoop_trial_matches_inprocess_trainer(tmp_path, weights, monkeypatch):  # noqa: F811
    """Seed 1 alone on the trial axis against the in-process trainer: the
    spec's init replays the trainer's ``KeySequence`` draws, and one batch
    per epoch gives both the same images per step."""
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    config = make_config(TConfig, tmp_path / "data", weights, METHOD)
    config.dataloader.batch_size_train = 64  # the whole 2-shot set
    config.output_dir = str(tmp_path / "inproc")
    set_random_seed(config.seed)
    tcache.memo_clear()
    trainer = build_trainer(config, build_data_manager(config))
    initial = {}
    build = trainer.build_model

    def build_and_record():
        build()
        initial.update(trial_specs.tree_map(lambda v: v.detach().clone(), trainer.params))

    trainer.build_model = build_and_record
    trainer.train()
    inproc = json.loads((tmp_path / "inproc" / "metrics.json").read_text())
    assert inproc["zero_shot"] is None

    tcache.memo_clear()
    runner = ttv.VmappedTrials(config, [config.seed], method=METHOD, device="cpu")
    starts = []
    init = runner._initial_params

    def init_and_record(spec):
        state = init(spec)  # trained in place later
        starts.append(trial_specs.tree_map(lambda v: v.detach().clone(), state))
        return state

    runner._initial_params = init_and_record
    [result] = runner.run([tmp_path / "trial"])
    for path, leaf in trial_specs.tree_leaves(initial):
        got = dict(trial_specs.tree_leaves(starts[0]))[path]
        torch.testing.assert_close(got[0].detach(), leaf, rtol=0, atol=0)
    got, want = result["metrics"], inproc["metrics"]
    assert got["top1_acc"] == want["top1_acc"]
    for key in ("ece", "aece", "macro_f1"):
        assert got[key] == pytest.approx(want[key], abs=INPROCESS_TOL), key
    for path, leaf in trial_specs.tree_leaves(trainer.params):
        torch.testing.assert_close(
            dict(trial_specs.tree_leaves(runner.params))[path][0], leaf.detach(),
            rtol=0, atol=INPROCESS_TOL)


def test_micro_slices_equal_unsplit_step(tmp_path, weights, monkeypatch, capsys):  # noqa: F811
    """T=2, K=4, a batch of 8 at 24 prompts a backward pass: 3 images, which
    the divisor snap makes 2, so each step is 4 backward passes and one
    update. Every parameter ends within 1e-6 of the unsplit run's."""
    def run(tag):
        config = make_config(TConfig, tmp_path / "data", weights, METHOD)
        config.dataset.num_shots = 4  # 16 images, batches of 8
        config.dataloader.batch_size_train = 8
        tcache.memo_clear()
        runner = ttv.VmappedTrials(config, SEEDS, method=METHOD, device="cpu")
        runner.run([tmp_path / tag / f"t{i}" for i in range(len(SEEDS))])
        return runner.params

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS", "24")
    micro = run("micro")
    assert "gradient accumulation: 2 images per backward (batch 8)" in capsys.readouterr().out
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS")
    whole = run("whole")
    assert "gradient accumulation" not in capsys.readouterr().out
    for path, leaf in trial_specs.tree_leaves(whole):
        torch.testing.assert_close(dict(trial_specs.tree_leaves(micro))[path], leaf,
                                   rtol=0, atol=MICRO_TOL, msg=path)


SIZES = [
    # (T, B, K, budget): no split, a split the snap shrinks, the one-image
    # floor, an exact fit, off
    (2, 8, 4, 1000), (2, 8, 4, 24), (5, 32, 1000, 90_000), (5, 32, 1000, 100),
    (4, 100, 100, 40_000), (3, 12, 7, 0), (3, 12, 7, -5),
]


@pytest.mark.parametrize("t,b,k,budget", SIZES)
def test_microbatch_images_matches_jax(monkeypatch, t, b, k, budget):
    monkeypatch.setenv("CLIP_GP_TPU_COCOOP_STEP_PROMPTS", str(budget))
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS", str(budget))
    got = trial_specs.cocoop_microbatch_images(t, b, k)
    assert got == jtv.cocoop_microbatch_images(t, b, k)
    assert b % got == 0
    assert got == b or t * got * k <= max(budget, t * k)
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_COCOOP_STEP_PROMPTS")
    assert trial_specs.cocoop_microbatch_images(t, b, k) == b  # unset: off


@pytest.mark.parametrize("n,cap", [(50, 11), (47, 5), (32, 18), (8, 3), (8, 8),
                                   (8, 100), (1, 1), (12, 0)])
def test_divisor_snap_matches_jax(n, cap):
    assert trial_specs._divisor_le(n, cap) == jtv._divisor_le(n, cap)
