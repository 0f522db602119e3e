"""Port TaskRes (``clip_gp_tpu_torch.methods.taskres``) and the pre-stages it
shares (``methods/pre_stages.py``) against the JAX package.

- Both CLIs (``train.main`` and ``clip_gp_tpu_torch.train.main``) end to end
  on TEST-RN (the ResNet tower of the paper's RN50 runs, cut to size), the
  Synthetic dataset, one npz and the same seed, no augmentation: plain
  TaskRes and TaskRes on the template-weight pre-stage (with its
  L2-to-uniform term) draw nothing at random, so top-1 must be equal, the
  other metrics within 1e-3 (percentage points, as
  tests/test_torch_train_e2e.py) and the saved residuals within 1e-4.
- The port alone: the GP branch runs, and ``--eval-only`` on the plain run
  reproduces its metrics from the checkpoint.
- The GP pre-stage (``train_gp_stage``) as TaskRes and Tip-Adapter run it
  and as CLIP-Adapter runs it, fed the JAX package's normal draws: its
  exported prototypes and posterior weights against JAX's.
- The template-weight pre-stage on the same inputs: weights and prototypes.
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

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.config import Config as JConfig  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.core.seeding import KeySequence as JKeys  # noqa: E402
from clip_gp_tpu.gp import svgp as jsvgp  # noqa: E402
from clip_gp_tpu.methods import pre_stages as jpre  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.config import Config as TConfig  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.core.seeding import KeySequence as TKeys  # noqa: E402
from clip_gp_tpu_torch.gp import svgp as tsvgp  # noqa: E402
from clip_gp_tpu_torch.methods import pre_stages as tpre  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES  # noqa: E402

METRICS = ("top1_acc", "macro_f1", "ece", "aece")
CONFIGS = {
    "taskres": [],
    "taskres-tw": ["TRAINER.ADAPTER.TASKRES_USE_TEMPLATE_WEIGHT_TRAINING", "True",
                   "TRAINER.ADAPTER.TEMPLATE_TW_L2_LAMBDA", "0.5"],
}


def _argv(root, out, weights, opts, flags=()):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-RN", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "3", "--trainer", "TaskRes",
        *flags, "INPUT.SIZE", "(64, 64)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights), *opts,
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "3", "OPTIM.MAX_EPOCH", "3",
        "TRAINER.ADAPTER.TASKRES_LR", "0.01",
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "1",
        "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    weights = base / "test_rn.npz"
    arch = ARCHITECTURES["TEST-RN"]
    # written by the port; test_torch_resnet.py holds the format to the JAX one
    save_params_npz(str(weights), arch, init_clip_params(arch, seed=0, device="cpu"))
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        for config, opts in CONFIGS.items():
            for side, cli, reset in (("jax", jax_cli, jax_reset_tee),
                                     ("port", port_cli, port_reset_tee)):
                out = base / f"{config}-{side}"
                try:
                    cli.main(_argv(base / f"data-{side}", out, weights, opts))
                finally:
                    reset()
                with (out / "metrics.json").open() as f:
                    results[config, side] = {
                        "metrics": json.load(f),
                        "ckpt": dict(np.load(out / "adapter" / "model.ckpt-3.npz")),
                    }
        # the port alone: the GP branch, and --eval-only on the plain run
        for name, opts, flags in (
                ("gp", ["TRAINER.ADAPTER.USE_GP", "True",
                        "TRAINER.ADAPTER.GP_PCA_DIM", "8"], ()),
                ("eval-only", [], ("--eval-only", "--model-dir",
                                   str(base / "taskres-port")))):
            out = base / f"{name}-port"
            try:
                port_cli.main(_argv(base / "data-port", out, weights, opts, flags))
            finally:
                port_reset_tee()
            with (out / "metrics.json").open() as f:
                results[name, "port"] = {"metrics": json.load(f),
                                         "log": (out / "log.txt").read_text()}
    return results


@pytest.mark.parametrize("config", list(CONFIGS))
def test_taskres_cli_matches_jax(runs, config):
    j, t = runs[config, "jax"]["metrics"], runs[config, "port"]["metrics"]
    assert t["method"] == j["method"] == "taskres"
    assert set(t) == set(j) and set(t["metrics"]) == set(j["metrics"])
    assert t["metrics"]["top1_acc"] == j["metrics"]["top1_acc"]
    for key in METRICS:
        assert t["metrics"][key] == pytest.approx(j["metrics"][key], abs=1e-3), key
    for key in ("top1_acc", "ece", "aece"):
        assert t["zero_shot"][key] == pytest.approx(j["zero_shot"][key], abs=1e-3), key
    j_ckpt, t_ckpt = runs[config, "jax"]["ckpt"], runs[config, "port"]["ckpt"]
    assert set(t_ckpt) == set(j_ckpt)
    expected = j_ckpt["state/residuals"]
    assert np.abs(expected).max() > 1e-3  # it trained
    np.testing.assert_allclose(t_ckpt["state/residuals"], expected, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_ckpt["state/base_text_features"],
                               j_ckpt["state/base_text_features"], rtol=0, atol=5e-5)


def test_gp_branch_runs_on_the_port(runs):
    run = runs["gp", "port"]
    assert run["metrics"]["method"] == "taskres"
    for key in METRICS:
        assert np.isfinite(run["metrics"]["metrics"][key]), key
    assert "[TaskRes] Using trained GP-based template weighter" in run["log"]


def test_eval_only_reload_reproduces_the_run(runs):
    """``--eval-only`` rebuilds the trainer, reloads the last checkpoint
    (residuals and base text features) and scores the test split as the
    training run did."""
    trained = runs["taskres", "port"]["metrics"]["metrics"]
    reloaded = runs["eval-only", "port"]["metrics"]["metrics"]
    assert "Loading checkpoint from" in runs["eval-only", "port"]["log"]
    for key in METRICS:
        assert reloaded[key] == pytest.approx(trained[key], abs=1e-9), key


# ---------------------------------------------------------------------------
# the pre-stages on the same inputs
# ---------------------------------------------------------------------------

def stage_inputs(k=5, m=4, d=32, n=20, seed=0):
    """Templates [K,M,D], normalized features [N,D] that lean towards their
    class's templates (so the classes are neither lost nor trivially
    separated, and training moves things), labels [N]."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(k, m, d)).astype(np.float32)
    labels = np.arange(n) % k
    feats = rng.normal(size=(n, d)).astype(np.float32) + 0.6 * e[labels].mean(axis=1)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return e, feats, labels.astype(np.int32)


def stage_configs(epochs=6, s_train=4, s_eval=8):
    out = []
    for cls in (JConfig, TConfig):
        c = cls()
        c.optim.max_epoch = epochs
        c.optim.weight_decay = 1e-2
        c.optim.lr = 0.05
        c.adapter.gp_lr = 0.05
        c.adapter.gp_pca_dim = 6
        c.adapter.gp_num_mc_samples_train = s_train
        c.adapter.gp_num_mc_samples_eval = s_eval
        c.adapter.template_init_method = "val_weighted"
        out.append(c)
    return out


def jax_gp_draws(seed, epochs, s_train, s_eval, k, m):
    """The normal draws the JAX ``train_gp_stage`` takes from
    ``KeySequence(seed)``: one per epoch out of ``epochs + 1`` keys, then one."""
    keys = JKeys(seed)
    eps = [np.array(jax.random.normal(key, (s_train, k, m)))
           for key in keys.next(epochs + 1)[:epochs]]
    eps.append(np.array(jax.random.normal(keys.next(), (s_eval, k, m))))
    return [torch.from_numpy(e) for e in eps]


@pytest.mark.parametrize("templates,warm_start_scale", [
    ("normalized", None), ("raw", 1 / 0.07)], ids=["taskres-tip", "clip-adapter"])
def test_gp_stage_with_the_jax_draws_matches_jax(templates, warm_start_scale, seed=3):
    """TaskRes's and Tip-Adapter's GP branch (per-template-normalized
    templates, warm start scored at 100) and CLIP-Adapter's (raw templates,
    scored at the CLIP logit scale). Compared: what the stage hands on, the
    exported prototypes (the MC mean over the same draws, so the posterior
    mean and covariance both count) and the posterior mean weights. Not the
    raw parameters: Adam divides each gradient by its own running size, so
    an element whose gradient is near zero (the prior mean's ``cls_bias`` and
    ``tmp_bias`` get only rounding noise, ~1e-8, as the sparsemax weights are
    blind to a constant shift) moves by up to the lr, either way, on both
    sides."""
    e, feats, labels = stage_inputs()
    if templates == "normalized":
        e /= np.linalg.norm(e, axis=-1, keepdims=True)
    jc, tc = stage_configs()
    k, m = e.shape[:2]
    (j_static, j_params, j_buffers), j_protos = jpre.train_gp_stage(
        jc, jnp.asarray(e), jnp.asarray(feats), labels, JKeys(seed),
        warm_start_scale=warm_start_scale)
    eps = jax_gp_draws(seed, 6, 4, 8, k, m)
    (t_static, t_params, t_buffers), t_protos = tpre.train_gp_stage(
        tc, torch.from_numpy(e), torch.from_numpy(feats), labels,
        TKeys(seed, "cpu"), warm_start_scale=warm_start_scale, eps=eps)
    assert set(t_params) == set(j_params)
    np.testing.assert_allclose(t_protos.numpy(), np.asarray(j_protos), rtol=0, atol=1e-4)
    j_w = np.asarray(jsvgp.posterior_mean_weights(j_static, j_params, j_buffers))
    t_w = tsvgp.posterior_mean_weights(t_static, t_params, t_buffers).numpy()
    assert np.abs(j_w - 1 / m).max() > 0.05  # the warm start and training moved them
    np.testing.assert_allclose(t_w, j_w, rtol=0, atol=1e-4)


def test_template_weight_stage_matches_jax():
    e, feats, labels = stage_inputs(seed=1)
    jc, tc = stage_configs()
    j_w, j_protos = jpre.train_template_weight_stage(
        jc, jnp.asarray(e), jnp.asarray(feats), labels, l2_to_uniform_lambda=0.5,
        n_batches=2)
    t_w, t_protos = tpre.train_template_weight_stage(
        tc, torch.from_numpy(e), torch.from_numpy(feats), labels,
        l2_to_uniform_lambda=0.5, n_batches=2)
    assert np.abs(np.asarray(j_w) - 0.25).max() > 1e-3  # it trained
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_protos.numpy(), np.asarray(j_protos), rtol=0, atol=1e-5)
