"""``TRAINER.ADAPTER.FINETUNE_ON_TEST`` (the Adapter's ``_finetune_on_test``)
in the port against the JAX package.

Both packages build the Adapter on TEST-ViT (one npz of weights), take the
JAX trainer's text embeddings, parameters and GP buffers, and the same 22
random test features (a ragged tail batch of 6 behind two of 8), then run
the sanity loop under the same numpy seed: 100 epochs of AdamW on a cosine
schedule, the visual projection frozen.

- uniform mode becomes logits mode initialized with the stored template
  weights; the final template logits agree within 1e-4;
- GP mode takes the JAX key stream's own draws (the port's sampling is fed
  ``jax.random.normal`` of each JAX key, as ``tests/test_torch_svgp.py``
  injects them); the final variational mean and covariance, lengthscale
  and outputscale agree within 1e-3 (they move by 0.3 to 0.8), and the
  posterior-mean template weights within 1e-4. ``cls_bias``, ``tmp_bias``
  and ``inducing_token`` are held to a zero gradient instead: the loss
  does not depend on them, so each side's Adam steps them by its own
  rounding noise.

In both, the visual projection is unchanged, the printed per-epoch loss
agrees within 1e-3 and the last ``[SANITY]`` accuracy is equal.
"""

import contextlib
import io
import re
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

import clip_gp_tpu.data.datasets  # noqa: E402,F401
import clip_gp_tpu.methods  # noqa: E402,F401
import clip_gp_tpu_torch.data.datasets  # noqa: E402,F401
import clip_gp_tpu_torch.methods  # noqa: E402,F401
from clip_gp_tpu.core.config import parse_args_to_config as jax_parse  # noqa: E402
from clip_gp_tpu.core.registry import build_trainer as jax_build  # noqa: E402
from clip_gp_tpu.data.pipeline import build_data_manager as jax_dm  # noqa: E402
from clip_gp_tpu.gp import svgp as jax_svgp  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu_torch.core.config import parse_args_to_config  # noqa: E402
from clip_gp_tpu_torch.core.registry import build_trainer  # noqa: E402
from clip_gp_tpu_torch.data.pipeline import build_data_manager  # noqa: E402
from clip_gp_tpu_torch.gp import svgp  # noqa: E402

MODES = {"uniform": ["TRAINER.ADAPTER.TRAIN_TEMPLATE_WEIGHTS", "False"],
         "gp": ["--use-gp", "TRAINER.ADAPTER.GP_PCA_DIM", "8",
                "TRAINER.ADAPTER.GP_NUM_MC_SAMPLES_TRAIN", "4",
                "TRAINER.ADAPTER.GP_NUM_MC_SAMPLES_EVAL", "8"]}
N_TEST = 22
# GP leaves the finetune loss does not depend on: sparsemax ignores a shift
# common to a class's templates (cls_bias), and the predictive at the
# template inputs, which are themselves inducing inputs, depends neither on
# the other inducing inputs (inducing_token) nor on tmp_bias
FLAT_LEAVES = ("cls_bias", "inducing_token", "tmp_bias")


def _argv(root, weights, mode):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(root / "out"),
        "--batch-size", "8", "--num-templates", "2", "--optimizer", "adamw",
        "--lr", "0.01", *MODES[mode][:1 if mode == "gp" else 0],
        "INPUT.SIZE", "(32, 32)", "MODEL.INIT_WEIGHTS", str(weights),
        "OPTIM.LR_SCHEDULER", "cosine", "OPTIM.MAX_EPOCH", "100",
        "DATALOADER.NUM_WORKERS", "0", "TRAINER.ADAPTER.FINETUNE_ON_TEST", "True",
        *(MODES[mode][1:] if mode == "gp" else MODES[mode]),
    ]


class _Replay:
    """The JAX trainer's key stream, handed out again in order."""

    def __init__(self, keys):
        self._keys = iter(keys)

    def next(self, n=1):
        return next(self._keys)


def _sanity(text):
    return [(float(loss), float(acc)) for loss, acc in re.findall(
        r"\[SANITY\] Template weights test fine-tune epoch \d+/100: "
        r"loss=([0-9.]+) acc_test=([0-9.]+)", text)]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree)


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, tmp_path_factory):
    mode = request.param
    base = tmp_path_factory.mktemp(f"fot-{mode}")
    weights = base / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N_TEST, arch.embed_dim)).astype(np.float32)
    labels = rng.integers(0, 4, size=N_TEST).astype(np.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        mp.setenv("CLIP_GP_TPU_ALLOW_RANDOM_WEIGHTS", "1")
        jc = jax_parse(_argv(base, weights, mode))
        jt = jax_build(jc, jax_dm(jc))
        jt.build_model()
        pc = parse_args_to_config(_argv(base, weights, mode))
        pt = build_trainer(pc, build_data_manager(pc))
        pt.build_model()
        assert pt.mode == jt.mode == mode

        pt.text_embeddings = torch.from_numpy(np.array(jt.text_embeddings))
        pt.logit_scale = jt.logit_scale
        if mode == "gp":
            pt.gp_buffers = pt._adopt_state(_np_tree(jt.gp_buffers))
        else:
            tw = rng.dirichlet(np.ones(2), size=4).astype(np.float32)
            jt._baseline_template_weights = jnp.asarray(tw)
            pt._baseline_template_weights = torch.from_numpy(tw)
        pt.load_trainable_state(_np_tree(jt.params))
        for t in (jt, pt):
            t.features_test, t.labels_test = feats, labels
            t._features_test_dev = None
        start = _np_tree(pt.params)
        if mode == "gp":
            # the start's gradient of each GP leaf, on the first test batch
            loss, _ = pt._loss(torch.from_numpy(feats[:8]), torch.from_numpy(labels[:8]),
                               torch.Generator().manual_seed(0), l2_reg=False)
            loss.backward()
            grads = {k: 0.0 if v.grad is None else float(v.grad.abs().max())
                     for k, v in pt.params["gp"].items()}
            pt.load_trainable_state(start)

        keys = []
        draw = jt.keys.next

        def record(n=1):
            keys.append(draw(n))
            return keys[-1]

        jt.keys.next = record
        out = {"mode": mode, "start": start, "grads": grads if mode == "gp" else None}
        np.random.seed(5)
        with contextlib.redirect_stdout(io.StringIO()) as log:
            jt._finetune_on_test()
        out["jax_log"] = log.getvalue()
        out["jax"] = _np_tree(jt.params)
        out["jax_weights"] = np.asarray(jax_svgp.posterior_mean_weights(
            jt.gp_static, jt.params["gp"], jt.gp_buffers)) if mode == "gp" else None

        def sample_prototypes(static, params, buffers, num_samples, eps=None,
                              generator=None, visual_embeddings=None):
            n = static.num_templates + (visual_embeddings is not None)
            eps = torch.from_numpy(np.array(jax.random.normal(
                generator, (num_samples, static.num_classes, n), jnp.float32)))
            return real(static, params, buffers, num_samples, eps=eps,
                        visual_embeddings=visual_embeddings)

        real = svgp.sample_prototypes
        if mode == "gp":
            mp.setattr(svgp, "sample_prototypes", sample_prototypes)
            pt.keys = _Replay(keys)
        np.random.seed(5)
        with contextlib.redirect_stdout(io.StringIO()) as log:
            pt._finetune_on_test()
        out["port_log"] = log.getvalue()
        out["port"] = _np_tree(pt.params)
        if mode == "gp":
            with torch.no_grad():
                out["port_weights"] = svgp.posterior_mean_weights(
                    pt.gp_static, pt.params["gp"], pt.gp_buffers).numpy()
        out["keys_left"] = sum(1 for _ in pt.keys._keys) if mode == "gp" else 0
    return out


def test_final_parameters_match_jax(runs):
    jax_p, port_p = runs["jax"], runs["port"]
    assert set(port_p) == set(jax_p)
    if runs["mode"] == "uniform":
        assert "template_logits" in port_p
        np.testing.assert_allclose(port_p["template_logits"], jax_p["template_logits"],
                                   rtol=0, atol=1e-4)
        moved = np.abs(jax_p["template_logits"] - runs["start"].get(
            "template_logits", 0)).max()
    else:
        for k, v in jax_p["gp"].items():
            if k in FLAT_LEAVES:
                # the loss does not depend on these: the port's gradient is
                # exactly 0, XLA's rounding noise, which Adam turns into
                # steps of the full lr; they are not compared
                assert runs["grads"][k] == 0.0, k
            else:
                np.testing.assert_allclose(port_p["gp"][k], v, rtol=0, atol=1e-3,
                                           err_msg=k)
        np.testing.assert_allclose(runs["port_weights"], runs["jax_weights"],
                                   rtol=0, atol=1e-4)
        moved = np.abs(jax_p["gp"]["variational_mean"]
                       - runs["start"]["gp"]["variational_mean"]).max()
        assert runs["keys_left"] == 0  # every JAX draw was used, in order
    assert moved > 1e-2
    np.testing.assert_array_equal(port_p["visual_proj"], runs["start"]["visual_proj"])


def test_sanity_lines_match_jax(runs):
    jax_lines, port_lines = _sanity(runs["jax_log"]), _sanity(runs["port_log"])
    assert len(port_lines) == len(jax_lines) == 100
    head = "[SANITY] Template weights fine-tuning on TEST set: epochs=100 bs=8 lr=0.01"
    assert head in runs["port_log"] and head in runs["jax_log"]
    for (p_loss, _), (j_loss, _) in zip(port_lines, jax_lines):
        assert p_loss == pytest.approx(j_loss, abs=1e-3)
    assert port_lines[-1][1] == jax_lines[-1][1]
