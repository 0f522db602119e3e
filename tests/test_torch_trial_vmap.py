"""The port's trial-batched runner (``clip_gp_tpu_torch.parallel.trial_vmap``)
against the JAX package's ``run_vmapped_trials`` on the same config, seeds,
weights (one TEST-ViT npz) and initial state, the Synthetic dataset with no
augmentation, Pallas in interpret mode on the JAX side.

- Deterministic heads (the Adapter without GP, TaskRes, Tip-Adapter-F,
  CoOp with its random context, CLIP-Adapter with its random MLP; the last
  two from the JAX run's initial state through ``trial_state_from_numpy``):
  per-trial top-1 equal, ECE and AECE within 5e-3 (percent units, the JAX
  suite's ``test_vmapped_head_matches_inprocess_trainer`` tolerance), the
  zero-shot block too, and each trial's exported checkpoint within 1e-4.
- An lr grid on the trial axis: each trial equals its own single-trial run
  of the port's runner.
- A trial's checkpoint served by the port's ``--eval-only`` with equal
  metrics.
- ``TrialOptimizer`` per trial against optax (``_core_transform`` +
  ``scale_by_learning_rate``) and Muon against the port's
  ``MuonWithAuxAdam``, each trial with its own lr.

The GP variants with the JAX draws injected are in
``tests/test_torch_trial_vmap_gp.py``.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from clip_gp_tpu.core.config import Config as JConfig  # noqa: E402
from clip_gp_tpu.parallel import trial_vmap as jtv  # noqa: E402
from clip_gp_tpu.runtime import feature_cache as jcache  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.config import Config as TConfig  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu_torch.parallel import trial_vmap as ttv  # noqa: E402
from clip_gp_tpu_torch.runtime import feature_cache as tcache  # noqa: E402
import clip_gp_tpu.data.datasets  # noqa: E402,F401
import clip_gp_tpu.methods  # noqa: E402,F401
import clip_gp_tpu_torch.data.datasets  # noqa: E402,F401
import clip_gp_tpu_torch.methods  # noqa: E402,F401

SEEDS = [1, 2]
N_CLASSES = 4  # the Synthetic dataset's
ECE_TOL = 5e-3
STATE_TOL = 1e-4


def make_config(cls, root, weights, method, **adapter):
    """The shared tiny config: TEST-ViT at 32 px from one npz, Synthetic at
    2 shots (8 images, batches of 4), 2 templates, no augmentation, 3
    epochs of sgd at lr 0.05 with a cosine schedule."""
    c = cls()
    c.trainer_name = method
    c.dataset.name = "Synthetic"
    c.dataset.root = str(root)
    c.dataset.num_shots = 2
    c.model.backbone_name = "TEST-ViT"
    c.model.init_weights = str(weights)
    c.input.size = (32, 32)
    c.input.transforms = []
    c.dataloader.batch_size_train = 4
    c.dataloader.batch_size_test = 8
    c.dataloader.num_workers = 0
    c.adapter.num_templates = 2
    for name in ("clip_adapter_epochs", "taskres_epochs", "tip_adapter_epochs"):
        setattr(c.adapter, name, 3)
    c.adapter.tip_adapter_trainable = True
    c.adapter.tip_adapter_init_beta = 1.0
    c.adapter.tip_adapter_init_alpha = 1.0
    c.adapter.clip_adapter_lr = 0.05
    c.adapter.taskres_lr = 0.05
    c.adapter.n_ctx = 2
    c.adapter.gp_pca_dim = 8
    c.adapter.gp_num_mc_samples_train = 4
    c.adapter.gp_num_mc_samples_eval = 8
    c.optim.max_epoch = 3
    c.optim.lr = 0.05
    c.train.enable_adapter_checkpoints = True
    c.seed = 1
    for k, v in adapter.items():
        setattr(c.adapter, k, v)
    return c


def jax_initial_state(method, config, seeds):
    """The JAX specs' random initial states, stacked over the trials (what
    the JAX runner stacks before its warm start)."""
    arch = ARCHITECTURES[config.model.backbone_name]
    if method == "CLIP-Adapter":
        d = arch.embed_dim
        hidden = max(1, d // max(1, int(config.adapter.clip_adapter_reduction)))
        trees = []
        for s in seeds:
            k1, k2 = jax.random.split(jax.random.key(int(s)))
            trees.append({
                "fc1": jax.random.uniform(k1, (d, hidden), minval=-1 / np.sqrt(d),
                                          maxval=1 / np.sqrt(d)),
                "fc2": jax.random.uniform(k2, (hidden, d), minval=-1 / np.sqrt(hidden),
                                          maxval=1 / np.sqrt(hidden)),
            })
    elif method == "Adapter-CoOp" and not config.adapter.ctx_init:
        shape = (int(config.adapter.n_ctx), arch.transformer_width)
        if config.adapter.csc:
            shape = (N_CLASSES,) + shape
        trees = [{"ctx": 0.02 * jax.random.normal(jax.random.key(int(s)), shape)}
                 for s in seeds]
    elif method == "Adapter" and config.adapter.use_linear_template_weighting:
        from clip_gp_tpu.core.seeding import KeySequence

        # the JAX spec replays its in-process init: the first draw of
        # KeySequence(seed); the identity projection comes with it
        trees = [{"visual_proj": np.eye(arch.embed_dim, dtype=np.float32),
                  "template_weight_linear": 0.01 * jax.random.normal(
                      KeySequence(int(s)).next(), (arch.embed_dim, 1))}
                 for s in seeds]
    else:
        return None
    return {k: np.stack([np.asarray(t[k]) for t in trees]) for k in trees[0]}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(path), arch, init_clip_params(arch, seed=0, device="cpu"))
    return path


def run_both(base, weights, method, seeds=SEEDS, overrides=None, **adapter):
    """The same group through both runners; returns, per side, the results
    and each trial's checkpoint arrays (flat npz keys)."""
    out = {}
    for side, cls, run, cache in (("jax", JConfig, jtv.run_vmapped_trials, jcache),
                                  ("port", TConfig, ttv.run_vmapped_trials, tcache)):
        config = make_config(cls, base / f"data-{side}", weights, method, **adapter)
        outdirs = [base / f"{side}-{method}" / f"t{i}" for i in range(len(seeds))]
        kwargs = {}
        if side == "port":
            kwargs = {"device": "cpu",
                      "initial_state": jax_initial_state(method, config, seeds)}
        cache.memo_clear()
        results = run(config, seeds, outdirs, trial_overrides=overrides,
                      method=method, **kwargs)
        ckpts = []
        for d in outdirs:
            files = sorted((d / "adapter").glob("model.ckpt-*.npz"))
            ckpts.append(dict(np.load(files[-1])) if files else None)
        out[side] = (results, ckpts, outdirs)
    return out


def assert_same_trials(runs, what):
    (jres, jck, jdirs), (tres, tck, tdirs) = runs["jax"], runs["port"]
    for t, (j, p) in enumerate(zip(jres, tres)):
        jm, pm = j["metrics"], p["metrics"]
        assert set(pm) == set(jm), what
        assert pm["top1_acc"] == jm["top1_acc"], (what, t, jm, pm)
        for key in ("ece", "aece"):
            assert pm[key] == pytest.approx(jm[key], abs=ECE_TOL), (what, t, key)
        if "macro_f1" in jm:
            assert pm["macro_f1"] == pytest.approx(jm["macro_f1"], abs=ECE_TOL)
        if j["zero_shot"] is None:  # CoCoOp computes no zero-shot block
            assert p["zero_shot"] is None, (what, t)
        else:
            assert p["zero_shot"]["top1_acc"] == j["zero_shot"]["top1_acc"], (what, t)
            assert p["zero_shot"]["ece"] == pytest.approx(j["zero_shot"]["ece"],
                                                          abs=ECE_TOL)
        if jck[t] is not None:
            assert set(tck[t]) == set(jck[t]), what
            for key in jck[t]:
                if key.startswith("state/"):
                    np.testing.assert_allclose(tck[t][key], jck[t][key],
                                               atol=STATE_TOL, rtol=0, err_msg=key)
        jj = json.loads((jdirs[t] / "metrics.json").read_text())
        tj = json.loads((tdirs[t] / "metrics.json").read_text())
        assert tj["method"] == jj["method"] and tj["seed"] == jj["seed"]
        assert set(tj) == set(jj)


HEADS = {
    "adapter": ("Adapter", {"template_init_method": "minmax"}),
    "adapter-freeze": ("Adapter", {"freeze_visual_proj": True}),
    "adapter-shared": ("Adapter", {"shared_template_weights": True,
                                   "template_init_method": "top3"}),
    "adapter-linear": ("Adapter", {"train_template_weights": False,
                                   "use_linear_template_weighting": True}),
    "taskres": ("TaskRes", {}),
    "taskres-tw": ("TaskRes", {"taskres_use_template_weight_training": True,
                               "template_tw_l2_lambda": 0.1}),
    "tip-adapter-f": ("Tip-Adapter", {}),
    "tip-adapter-f-tw": ("Tip-Adapter", {"tip_adapter_use_template_weight_training": True}),
    "coop": ("Adapter-CoOp", {}),
    "coop-csc": ("Adapter-CoOp", {"csc": True}),
    "coop-ctx-init": ("Adapter-CoOp", {"ctx_init": "a photo of a"}),
    "clip-adapter": ("CLIP-Adapter", {}),
    "clip-adapter-tw": ("CLIP-Adapter", {"clip_adapter_use_template_weight_training": True}),
}


@pytest.mark.parametrize("method,adapter", list(HEADS.values()), ids=list(HEADS))
def test_head_matches_jax_runner(tmp_path, weights, method, adapter):
    runs = run_both(tmp_path, weights, method, **adapter)
    assert_same_trials(runs, method)
    # the trials learned something of their own
    tres = runs["port"][0]
    assert all(np.isfinite(r["metrics"]["top1_acc"]) for r in tres)


def test_lr_grid_trials_equal_single_trial_runs(tmp_path, weights):
    """OPTIM.LR on the trial axis: each trial equals its own T=1 run."""
    lrs = [0.01, 0.2]
    config = make_config(TConfig, tmp_path / "data", weights, "Adapter")
    grid = ttv.run_vmapped_trials(config, [1, 1], [tmp_path / "g0", tmp_path / "g1"],
                                  trial_overrides=[{"lr": x} for x in lrs],
                                  method="Adapter", device="cpu")
    assert grid[0]["metrics"]["ece"] != grid[1]["metrics"]["ece"]
    for i, lr in enumerate(lrs):
        tcache.memo_clear()
        alone = ttv.run_vmapped_trials(config, [1], [tmp_path / f"a{i}"],
                                       trial_overrides=[{"lr": lr}],
                                       method="Adapter", device="cpu")[0]
        assert alone["metrics"]["top1_acc"] == grid[i]["metrics"]["top1_acc"]
        for key in ("ece", "aece", "macro_f1"):
            assert alone["metrics"][key] == pytest.approx(grid[i]["metrics"][key],
                                                          abs=1e-4)
        a = np.load(tmp_path / f"a{i}" / "adapter" / "model.ckpt-3.npz")
        g = np.load(tmp_path / f"g{i}" / "adapter" / "model.ckpt-3.npz")
        np.testing.assert_allclose(a["state/visual_proj"], g["state/visual_proj"],
                                   atol=1e-6)
        payload = json.loads((tmp_path / f"g{i}" / "metrics.json").read_text())
        assert payload["config"]["optim"]["lr"] == lr


@pytest.mark.parametrize("method", ["Adapter", "CLIP-Adapter", "TaskRes",
                                    "Adapter-CoOp"])
def test_checkpoint_serves_through_eval_only(tmp_path, weights, monkeypatch, method):
    """A trial's checkpoint, reloaded by the port's ``--eval-only``, gives
    the trial's metrics (the counterpart of the JAX suite's
    ``test_vmap_checkpoint_eval_only_roundtrip``)."""
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    config = make_config(TConfig, tmp_path / "data", weights, method)
    outdirs = [tmp_path / "s1", tmp_path / "s2"]
    ttv.run_vmapped_trials(config, SEEDS, outdirs, method=method)
    evaldir = tmp_path / "eval"
    try:
        port_cli.main([
            "--dataset", "Synthetic", "--root", str(tmp_path / "data"),
            "--shots", "2", "--backbone", "TEST-ViT", "--seed", "1",
            "--output-dir", str(evaldir), "--batch-size", "4",
            "--num-templates", "2", "--trainer", method, "--n-ctx", "2",
            "--eval-only", "--model-dir", str(outdirs[0]),
            "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "[]",
            "MODEL.INIT_WEIGHTS", str(weights), "DATALOADER.NUM_WORKERS", "0",
        ])
    finally:
        reset_tee()
    served = json.loads((evaldir / "metrics.json").read_text())["metrics"]
    trained = json.loads((outdirs[0] / "metrics.json").read_text())["metrics"]
    assert served["top1_acc"] == trained["top1_acc"]
    for key in ("ece", "aece", "macro_f1"):
        assert served[key] == pytest.approx(trained[key], abs=1e-3), key


# ----------------------------------------------------------------------
# the update math
# ----------------------------------------------------------------------

OPTIMIZERS = [
    {"name": "sgd", "weight_decay": 5e-4, "momentum": 0.9, "nesterov": False},
    {"name": "sgd", "weight_decay": 0.0, "momentum": 0.9, "nesterov": True},
    {"name": "adam", "weight_decay": 1e-3},
    {"name": "adamw", "weight_decay": 1e-2, "eps": 1e-6},
]


@pytest.mark.parametrize("opt", OPTIMIZERS,
                         ids=["sgd-l2", "sgd-nesterov", "adam-l2", "adamw"])
def test_trial_optimizer_matches_optax_per_trial(opt):
    """Three trials, each with its own lr per step, against optax's
    ``_core_transform`` + ``scale_by_learning_rate`` run on each trial alone."""
    from types import SimpleNamespace

    from clip_gp_tpu.runtime.optim import _core_transform

    cfg = SimpleNamespace(**{"betas": (0.9, 0.999), "eps": 1e-8, **opt})
    rng = np.random.default_rng(0)
    t_trials, steps = 3, 4
    p0 = rng.normal(size=(t_trials, 5, 3)).astype(np.float32)
    grads = rng.normal(size=(steps, t_trials, 5, 3)).astype(np.float32)
    lrs = rng.uniform(0.01, 0.1, size=(steps, t_trials)).astype(np.float32)

    from clip_gp_tpu_torch.parallel.trial_specs import TrialOptimizer

    p = torch.tensor(p0)
    topt = TrialOptimizer.from_config(cfg)
    for s in range(steps):
        p.grad = torch.tensor(grads[s])
        topt.step([(p, torch.tensor(lrs[s]))])
    for t in range(t_trials):
        q = jnp.asarray(p0[t])
        tx = _core_transform(cfg)
        state = tx.init(q)
        for s in range(steps):
            u, state = tx.update(jnp.asarray(grads[s, t]), state, q)
            q = q + u * (-lrs[s, t])
        np.testing.assert_allclose(p[t].numpy(), np.asarray(q), rtol=1e-5, atol=1e-6)


def test_trial_optimizer_muon_matches_single_trial():
    """Muon per trial: a [T, 6, 4] leaf (Newton–Schulz, batched) and a [T, 4]
    leaf (Adam) against the port's ``MuonWithAuxAdam`` on each trial."""
    from types import SimpleNamespace

    from clip_gp_tpu_torch.parallel.trial_specs import TrialOptimizer
    from clip_gp_tpu_torch.runtime.optim import MuonWithAuxAdam

    cfg = SimpleNamespace(name="muon", weight_decay=0.01, betas=(0.9, 0.999))
    rng = np.random.default_rng(1)
    t_trials, steps = 2, 3
    w0 = rng.normal(size=(t_trials, 6, 4)).astype(np.float32)
    b0 = rng.normal(size=(t_trials, 4)).astype(np.float32)
    gw = rng.normal(size=(steps, t_trials, 6, 4)).astype(np.float32)
    gb = rng.normal(size=(steps, t_trials, 4)).astype(np.float32)
    lrs = np.asarray([0.02, 0.05], np.float32)
    w, b = torch.tensor(w0), torch.tensor(b0)
    topt = TrialOptimizer.from_config(cfg)
    for s in range(steps):
        w.grad, b.grad = torch.tensor(gw[s]), torch.tensor(gb[s])
        topt.step([(w, torch.tensor(lrs)), (b, torch.tensor(lrs))])
    for t in range(t_trials):
        wt, bt = torch.tensor(w0[t]), torch.tensor(b0[t])
        single = MuonWithAuxAdam([wt, bt], lr=float(lrs[t]), weight_decay=0.01)
        for s in range(steps):
            wt.grad, bt.grad = torch.tensor(gw[s, t]), torch.tensor(gb[s, t])
            single.step()
        np.testing.assert_allclose(w[t].numpy(), wt.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b[t].numpy(), bt.numpy(), rtol=1e-5, atol=1e-6)
