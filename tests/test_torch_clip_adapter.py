"""Port CLIP-Adapter (``clip_gp_tpu_torch.methods.clip_adapter``) against the
JAX package.

- Both CLIs end to end on TEST-RN, the Synthetic dataset, one npz and the
  same seed, no augmentation, with the port's adapter initialized from the
  JAX run's own uniform draws (``init_adapter(uniforms=)``): the initial
  adapters are equal to 1e-7, then top-1 must be equal, the other metrics
  within 1e-3 (percentage points, as tests/test_torch_train_e2e.py) and the
  saved adapter within 1e-4. Every step re-encodes the few-shot images
  through the frozen ResNet tower on both sides.
- ``--use-gp`` (the GP pre-stage's prototypes as the classifier) on the
  port: finite metrics, and the classifier's columns are MC means of unit
  prototypes, shorter than 1 where the samples disagree; ``--eval-only``
  on that run reloads it and scores the test split as the run did.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.methods import clip_adapter as jca  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.methods import clip_adapter as tca  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES  # noqa: E402

METRICS = ("top1_acc", "macro_f1", "ece", "aece")


def _argv(root, out, weights, *opts, flags=()):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-RN", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "3", "--trainer", "CLIP-Adapter",
        *flags, "INPUT.SIZE", "(64, 64)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights), *opts,
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "3", "OPTIM.MAX_EPOCH", "3",
        "TRAINER.ADAPTER.CLIP_ADAPTER_LR", "0.01",
        "TRAINER.ADAPTER.GP_PCA_DIM", "8",
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "1",
        "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
    ]


def _record_build(cls, into):
    """``cls.build_model`` that also keeps a numpy copy of the initial adapter."""
    build = cls.build_model

    def wrapped(self):
        build(self)
        into.update({k: np.array(v.detach()) if hasattr(v, "detach") else np.array(v)
                     for k, v in self.params.items()})
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    weights = base / "test_rn.npz"
    arch = ARCHITECTURES["TEST-RN"]
    # written by the port; test_torch_resnet.py holds the format to the JAX one
    save_params_npz(str(weights), arch, init_clip_params(arch, seed=0, device="cpu"))
    results, init, uniforms = {}, {"jax": {}, "port": {}}, []
    real_uniform = jax.random.uniform

    def recording_uniform(key, shape, *args, **kwargs):
        # the U[0, 1) draw behind each jax.random.uniform(minval, maxval)
        uniforms.append(np.array(real_uniform(key, shape)))
        return real_uniform(key, shape, *args, **kwargs)

    def run(side, cli, reset, *opts, name=None, flags=()):
        out = base / (name or side)
        try:
            cli.main(_argv(base / f"data-{side}", out, weights, *opts, flags=flags))
        finally:
            reset()
        ckpt = out / "adapter" / "model.ckpt-3.npz"
        with (out / "metrics.json").open() as f:
            return {"metrics": json.load(f), "log": (out / "log.txt").read_text(),
                    "ckpt": dict(np.load(ckpt)) if ckpt.exists() else None}

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        with pytest.MonkeyPatch.context() as mp_jax:
            mp_jax.setattr(jca.Trainer, "build_model",
                           _record_build(jca.Trainer, init["jax"]))
            mp_jax.setattr(jax.random, "uniform", recording_uniform)
            results["jax"] = run("jax", jax_cli, jax_reset_tee)
        fc1, fc2 = uniforms[:2]
        with pytest.MonkeyPatch.context() as mp_port:
            mp_port.setattr(tca.Trainer, "build_model",
                            _record_build(tca.Trainer, init["port"]))
            mp_port.setattr(tca, "init_adapter", functools.partial(
                tca.init_adapter, uniforms={"fc1": fc1, "fc2": fc2}))
            results["port"] = run("port", port_cli, port_reset_tee)
        results["port-gp"] = run("port", port_cli, port_reset_tee,
                                 "TRAINER.ADAPTER.USE_GP", "True", name="port-gp")
        results["port-gp-eval"] = run(
            "port", port_cli, port_reset_tee, "TRAINER.ADAPTER.USE_GP", "True",
            name="port-gp-eval", flags=("--eval-only", "--model-dir", str(base / "port-gp")))
    results["init"] = init
    return results


def test_port_starts_from_the_jax_adapter(runs):
    j, t = runs["init"]["jax"], runs["init"]["port"]
    assert set(t) == set(j) == {"fc1", "fc2"}
    assert j["fc1"].shape == (32, 8)  # embed 32, reduction 4
    for key in j:
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-7, err_msg=key)


def test_clip_adapter_cli_matches_jax(runs):
    j, t = runs["jax"]["metrics"], runs["port"]["metrics"]
    assert t["method"] == j["method"] == "clip-adapter"
    assert set(t) == set(j) and set(t["metrics"]) == set(j["metrics"])
    assert t["metrics"]["top1_acc"] == j["metrics"]["top1_acc"]
    for key in METRICS:
        assert t["metrics"][key] == pytest.approx(j["metrics"][key], abs=1e-3), key
    for key in ("top1_acc", "ece", "aece"):
        assert t["zero_shot"][key] == pytest.approx(j["zero_shot"][key], abs=1e-3), key
    j_ckpt, t_ckpt = runs["jax"]["ckpt"], runs["port"]["ckpt"]
    assert set(t_ckpt) == set(j_ckpt)
    for key in ("state/adapter/fc1", "state/adapter/fc2"):
        moved = np.abs(j_ckpt[key] - runs["init"]["jax"][key.rsplit("/", 1)[1]]).max()
        assert moved > 1e-3, key  # it trained
        np.testing.assert_allclose(t_ckpt[key], j_ckpt[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(t_ckpt["state/clip_weights"], j_ckpt["state/clip_weights"],
                               rtol=0, atol=5e-5)


def test_gp_classifier_is_the_unnormalized_mc_mean(runs):
    run = runs["port-gp"]
    assert run["metrics"]["method"] == "clip-adapter"
    for key in METRICS:
        assert np.isfinite(run["metrics"]["metrics"][key]), key
    assert "[CLIP-Adapter] Using trained GP-based template weighter" in run["log"]
    norms = np.linalg.norm(run["ckpt"]["state/clip_weights"], axis=0)
    assert norms.shape == (4,) and (norms <= 1 + 1e-6).all() and norms.min() < 1 - 1e-4


def test_eval_only_reload_reproduces_the_gp_run(runs):
    """``--eval-only`` rebuilds the trainer, reloads the adapter and the GP
    classifier (kept unnormalized, as the config says) and scores the test
    split as the training run did."""
    trained = runs["port-gp"]["metrics"]["metrics"]
    reloaded = runs["port-gp-eval"]["metrics"]["metrics"]
    assert "Loading checkpoint from" in runs["port-gp-eval"]["log"]
    for key in METRICS:
        assert reloaded[key] == pytest.approx(trained[key], abs=1e-9), key
