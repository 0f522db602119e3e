"""Reference-format checkpoints (``model.pth.tar-*``) in the port
(``runtime/ref_checkpoint.py``, ``adopt_reference_state``) against the JAX
package's.

Each fixture is written as the reference saves one (``utils/trainer.py``
347-374): ``torch.save`` of ``{"state_dict", "epoch", "optimizer",
"scheduler"}``, the state dict under the reference's module key names
(with frozen tower keys the converters skip), the optimizer and scheduler
entries the state dicts of a real ``torch.optim.AdamW`` and
``CosineAnnealingLR``. Its values are a port trainer's fresh state, moved by
seeded noise, on TEST-ViT: the Adapter with template logits and with the GP,
CLIP-Adapter, TaskRes, CoOp and CoCoOp. The GP fixture lives in another PCA
basis than the one the trainer derives: torch's SVD gives other column
signs, and the fixture goes further and rotates the basis by a random
orthogonal matrix, so serving it is right only if the checkpoint's own
basis is adopted.

- Conversion: both packages' ``convert_reference_checkpoint`` give equal
  arrays (state and GP buffers) and the epoch.
- Serving: ``--eval-only --model-dir`` in both CLIs: top-1 equal, metrics
  within 1e-3 (percentage points). The GP run's evaluation draws its noise
  from the JAX key stream on both sides (the port fed ``jax.random.normal``
  of each key, as ``tests/test_torch_svgp.py`` injects them).
- The port adopts the rotated basis (within 1e-5 of the fixture's) and the
  JAX package's buffers exactly; the files load with
  ``torch.load(weights_only=True)``, and a file holding a pickled object is
  refused.
- The errors of the JAX loader: Tip-Adapter (never saved by the
  reference), an unknown trainer, a missing key, a GP checkpoint under a
  non-GP config and an rbf checkpoint under a Matern config.
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

import clip_gp_tpu_torch.data.datasets  # noqa: E402,F401
import clip_gp_tpu_torch.methods  # noqa: E402,F401
import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.core.seeding import KeySequence as JaxKeySequence  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu.runtime import ref_checkpoint as jax_ref  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.config import parse_args_to_config  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.core.registry import build_trainer  # noqa: E402
from clip_gp_tpu_torch.core.seeding import set_random_seed  # noqa: E402
from clip_gp_tpu_torch.data.pipeline import build_data_manager  # noqa: E402
from clip_gp_tpu_torch.gp import svgp  # noqa: E402
from clip_gp_tpu_torch.runtime import ref_checkpoint  # noqa: E402
from clip_gp_tpu_torch.runtime import trainer_base  # noqa: E402

GP_OPTS = ["TRAINER.ADAPTER.GP_PCA_DIM", "6", "TRAINER.ADAPTER.GP_NUM_MC_SAMPLES_EVAL", "8"]
KINDS = {  # name → (flags, OPTS)
    "adapter_logits": ([], []),
    "adapter_gp": (["--use-gp"], GP_OPTS),
    "clip_adapter": (["--trainer", "CLIP-Adapter"], []),
    "taskres": (["--trainer", "TaskRes"], []),
    "coop": (["--trainer", "Adapter-CoOp", "--ctx-init", "a photo of a"], []),
    "cocoop": (["--trainer", "Adapter-CoCoOp", "--n-ctx", "2"], []),
}
METRICS = ("top1_acc", "macro_f1", "ece", "aece")
ROTATION = np.linalg.qr(np.random.default_rng(9).normal(size=(6, 6)))[0].astype(np.float32)


def _argv(base, out, kind, extra=(), opts=()):
    flags, kind_opts = KINDS[kind]
    return [
        "--dataset", "Synthetic", "--root", str(base / "data"), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "2", *flags, *extra,
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(base / "test_vit.npz"),
        "DATALOADER.NUM_WORKERS", "0", *kind_opts, *opts,
    ]


def _np(x):
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


def _reference_state_dict(kind, state, buffers, rng):
    """The reference module's state_dict for a port state, values moved by
    seeded noise (the inverse of the converters, written from the reference
    modules' key names)."""
    def moved(a, scale=0.05):
        a = _np(a)
        return torch.from_numpy((a + scale * rng.normal(size=a.shape)).astype(np.float32))

    sd = {"image_encoder.conv1.weight": torch.zeros(4, 3, 2, 2),
          "logit_scale": torch.tensor(4.6)}
    if kind == "adapter_logits":
        sd["visual_proj.weight"] = moved(state["visual_proj"])
        sd["template_weights"] = moved(state["template_logits"], 1.0)
    elif kind == "adapter_gp":
        gp, d = state["gp"], buffers["templates_red"].shape[-1]
        g = "gp_weighter."
        vd = g + "variational_strategy._variational_distribution."
        templates_red = _np(buffers["templates_red"]) @ ROTATION[:d, :d]
        token = _np(moved(gp["inducing_token"], 0.1)) @ ROTATION[:d, :d]
        sd.update({
            "visual_proj.weight": moved(state["visual_proj"]),
            g + "_templates": torch.from_numpy(_np(buffers["templates"])),
            g + "_templates_red": torch.from_numpy(templates_red),
            g + "variational_strategy.inducing_points": torch.from_numpy(
                np.concatenate([templates_red, token], axis=1)),
            vd + "variational_mean": moved(gp["variational_mean"], 0.5),
            vd + "chol_variational_covar": moved(gp["chol_variational_covar"], 0.02),
            g + "mean_module.cls_bias": moved(gp["cls_bias"]),
            g + "mean_module.tmp_bias": moved(gp["tmp_bias"]),
            g + "mean_module.f0": torch.from_numpy(_np(buffers["f0"])),
            g + "A.weight": moved(gp["A"]),
            g + "covar_module.base_kernel.raw_lengthscale": moved(gp["raw_lengthscale"]),
            g + "covar_module.raw_outputscale": moved(gp["raw_outputscale"]),
        })
    elif kind == "clip_adapter":
        sd["adapter.fc1.weight"] = moved(_np(state["adapter"]["fc1"]).T)
        sd["adapter.fc2.weight"] = moved(_np(state["adapter"]["fc2"]).T)
        sd["clip_weights"] = moved(state["clip_weights"])
    elif kind == "taskres":
        sd["taskres_learner.text_feature_residuals"] = moved(state["residuals"], 0.2)
        sd["taskres_learner.base_text_features"] = moved(state["base_text_features"])
    else:
        sd["prompt_learner.ctx"] = moved(state["ctx"], 0.1)
        if kind == "cocoop":
            for i, name in ((0, "meta_fc1"), (2, "meta_fc2")):
                sd[f"prompt_learner.meta_net.{i}.weight"] = moved(_np(state[name]["w"]).T)
                sd[f"prompt_learner.meta_net.{i}.bias"] = moved(state[name]["b"])
    return sd


def _save_reference(path, sd, epoch):
    """The reference's artifact (ref: utils/trainer.py:347-374)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    params = [torch.nn.Parameter(torch.zeros(3))]
    opt = torch.optim.AdamW(params, lr=0.01)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=5)
    params[0].grad = torch.ones(3)
    opt.step()
    sched.step()
    torch.save({"state_dict": sd, "epoch": epoch, "optimizer": opt.state_dict(),
                "scheduler": sched.state_dict()}, path)


class _JaxKeys:
    """The JAX package's key stream in the port's KeySequence seat."""

    def __init__(self, seed, device=None):
        self._keys = JaxKeySequence(seed)

    def next(self, n=1):
        return self._keys.next(n)


def _jax_draws(real):
    def sample_prototypes(static, params, buffers, num_samples, eps=None,
                          generator=None, visual_embeddings=None):
        n = static.num_templates + (visual_embeddings is not None)
        eps = torch.from_numpy(np.array(jax.random.normal(
            generator, (num_samples, static.num_classes, n), jnp.float32)))
        return real(static, params, buffers, num_samples, eps=eps,
                    visual_embeddings=visual_embeddings)
    return sample_prototypes


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("refckpt")
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(base / "test_vit.npz"), arch,
                    init_clip_params(jax.random.key(0), arch))
    rng = np.random.default_rng(0)
    fixtures = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        for kind in KINDS:
            config = parse_args_to_config(_argv(base, base / "build", kind))
            set_random_seed(config.seed)
            trainer = build_trainer(config, build_data_manager(config))
            trainer.build_model()
            buffers = getattr(trainer, "gp_buffers", None)
            sd = _reference_state_dict(kind, trainer.trainable_state(), buffers, rng)
            path = base / f"ref-{kind}" / "adapter" / "model.pth.tar-3"
            _save_reference(path, sd, epoch=3)
            fixtures[kind] = {"path": path, "sd": sd, "trainer_name": config.trainer_name}
        yield {"base": base, "fixtures": fixtures, "mp": mp}


def _serve(env, side, kind):
    base = env["base"]
    out = base / f"eval-{side}-{kind}"
    argv = _argv(base, out, kind, extra=["--eval-only", "--model-dir",
                                         str(base / f"ref-{kind}")])
    cli, reset = (jax_cli, jax_reset_tee) if side == "jax" else (port_cli, port_reset_tee)
    with pytest.MonkeyPatch.context() as mp:
        if side == "port" and kind == "adapter_gp":
            mp.setattr(trainer_base, "KeySequence", _JaxKeys)
            mp.setattr(svgp, "sample_prototypes", _jax_draws(svgp.sample_prototypes))
        try:
            cli.main(argv)
        finally:
            reset()
    return json.loads((out / "metrics.json").read_text())


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=where)


@pytest.mark.parametrize("kind", list(KINDS))
def test_conversion_matches_jax(env, kind):
    fx = env["fixtures"][kind]
    state, extra, epoch = ref_checkpoint.convert_reference_checkpoint(
        fx["path"], fx["trainer_name"])
    j_state, j_extra, j_epoch = jax_ref.convert_reference_checkpoint(
        fx["path"], fx["trainer_name"])
    assert epoch == j_epoch == 3
    _assert_tree_equal(state, j_state)
    _assert_tree_equal(extra, j_extra)
    assert ("gp_buffers" in extra) == (kind == "adapter_gp")


@pytest.mark.parametrize("kind", list(KINDS))
def test_eval_only_serves_as_jax(env, kind):
    jax_run, port_run = _serve(env, "jax", kind), _serve(env, "port", kind)
    assert port_run["method"] == jax_run["method"]
    assert port_run["metrics"]["top1_acc"] == jax_run["metrics"]["top1_acc"]
    for key in METRICS:
        assert port_run["metrics"][key] == pytest.approx(
            jax_run["metrics"][key], abs=1e-3), key


def _port_trainer(env, kind, opts=()):
    config = parse_args_to_config(_argv(env["base"], env["base"] / "build", kind,
                                        opts=opts))
    trainer = build_trainer(config, build_data_manager(config))
    trainer.build_model()
    return trainer


def test_gp_adopts_the_checkpoint_basis(env):
    fx = env["fixtures"]["adapter_gp"]
    trainer = _port_trainer(env, "adapter_gp")
    derived = _np(trainer.gp_buffers["pca_W"])
    assert trainer.load_model(str(fx["path"].parent.parent)) == 3
    adopted = {k: _np(v) for k, v in trainer.gp_buffers.items()}
    _, j_extra, _ = jax_ref.convert_reference_checkpoint(fx["path"], "Adapter")
    _assert_tree_equal(adopted, j_extra["gp_buffers"])
    np.testing.assert_allclose(adopted["pca_W"], derived @ ROTATION, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(adopted["templates_red"],
                                  fx["sd"]["gp_weighter._templates_red"].numpy())


def test_reference_files_load_weights_only(env, tmp_path):
    for fx in env["fixtures"].values():
        ckpt = torch.load(fx["path"], map_location="cpu", weights_only=True)
        assert set(ckpt) == {"state_dict", "epoch", "optimizer", "scheduler"}
    bad = tmp_path / "adapter" / "model.pth.tar-1"
    bad.parent.mkdir(parents=True)
    torch.save({"state_dict": env["fixtures"]["coop"]["sd"], "epoch": 1,
                "scheduler": _Pickled()}, bad)
    with pytest.raises(Exception, match="[Ww]eights only load failed"):
        ref_checkpoint.convert_reference_checkpoint(bad, "Adapter-CoOp")


class _Pickled:
    """An object that only a full unpickle can rebuild."""


@pytest.mark.parametrize("name", ["Tip-Adapter", "Adapter-TipA-F"])
def test_tip_adapter_is_refused_as_in_jax(env, name):
    path = env["fixtures"]["adapter_logits"]["path"]
    for convert in (ref_checkpoint.convert_reference_checkpoint,
                    jax_ref.convert_reference_checkpoint):
        with pytest.raises(ValueError, match="never saves Tip-Adapter"):
            convert(path, name)


def test_unknown_trainer_and_missing_key_raise_as_in_jax(env):
    path = env["fixtures"]["adapter_logits"]["path"]
    for convert in (ref_checkpoint.convert_reference_checkpoint,
                    jax_ref.convert_reference_checkpoint):
        with pytest.raises(ValueError, match="no reference-checkpoint converter"):
            convert(path, "Nope")
        with pytest.raises(KeyError, match="taskres_learner"):
            convert(path, "TaskRes")


@pytest.mark.parametrize("opts,match", [
    ([], "carries GP state"),
    (GP_OPTS + ["--use-gp", "TRAINER.ADAPTER.GP_KERNEL_TYPE", "matern"], "kernel"),
], ids=["gp_into_baseline", "rbf_into_matern"])
def test_mismatched_config_is_refused(env, opts, match):
    flags = [o for o in opts if o.startswith("--")]
    rest = [o for o in opts if not o.startswith("--")]
    config = parse_args_to_config(
        _argv(env["base"], env["base"] / "build", "adapter_logits", extra=flags, opts=rest))
    trainer = build_trainer(config, build_data_manager(config))
    trainer.build_model()
    with pytest.raises(ValueError, match=match):
        trainer.load_model(str(env["fixtures"]["adapter_gp"]["path"].parent.parent))
