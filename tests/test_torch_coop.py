"""Port CoOp and CoCoOp (``clip_gp_tpu_torch.methods.coop`` / ``cocoop``)
against the JAX package.

- The prompt parts (``build_prompt_parts`` with a shared, class-specific or
  phrase-initialised context, ``trim_prompt_parts``, ``assemble_prompts``)
  from one TEST-ViT npz, with the JAX random context draw fed to the port:
  equal to the last bit, since both gather the same embedding rows and scale
  the same draw.
- The CoCoOp meta-net init from the JAX uniform draws, and
  ``conditional_logits`` in one tower call, in image chunks and in prompt
  sub-slices (set through ``PROMPT_BUDGET``), against JAX with the same
  parameters: logits at 5e-5 (the towers' tolerance, tests/
  test_torch_clip_model.py) and gradients at rtol 1e-4 / atol 1e-5.
- Both CLIs end to end (``train.main`` and ``clip_gp_tpu_torch.train.main``)
  with TEST-ViT, the Synthetic dataset and one npz from the JAX
  ``save_params_npz``, as tests/test_torch_train_e2e.py runs them. CoOp with
  ``--ctx-init "a photo of a"`` draws nothing at random, so top-1 must be
  equal, the other metrics within 1e-3 (percentage points) and the saved
  context within 1e-4. CoCoOp runs with the JAX run's initial context and
  meta-net loaded into the port: its metrics.json has the JAX schema and
  finite values.
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
from clip_gp_tpu.methods import cocoop as jcocoop  # noqa: E402
from clip_gp_tpu.methods import coop as jcoop  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.config import Config as TConfig  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.methods import cocoop as tcocoop  # noqa: E402
from clip_gp_tpu_torch.methods import coop as tcoop  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import load_params_npz  # noqa: E402

CLASSNAMES = ["red circle", "green square", "blue stripe", "yellow dot",
              "pattern 4"]
METRICS = ("top1_acc", "macro_f1", "ece", "aece")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    arch = ARCHITECTURES["TEST-ViT"]
    params = init_clip_params(jax.random.key(0), arch)
    path = tmp_path_factory.mktemp("weights") / "test_vit.npz"
    save_params_npz(str(path), arch, params)
    _, model = load_params_npz(str(path), device="cpu")
    return {"arch": arch, "params": params, "model": model, "path": path}


def _configs(n_ctx=3, ctx_init="", csc=False):
    configs = []
    for cls in (JConfig, TConfig):
        c = cls()
        c.adapter.n_ctx, c.adapter.ctx_init, c.adapter.csc = n_ctx, ctx_init, csc
        configs.append(c)
    return configs


@pytest.mark.parametrize("case", [dict(), dict(csc=True),
                                  dict(ctx_init="a photo of a")],
                         ids=["shared", "csc", "ctx-init"])
def test_prompt_parts_match_jax(weights, case):
    jc, tc = _configs(**case)
    j_ctx, j_pre, j_suf, j_tok, j_n = jcoop.build_prompt_parts(
        jc, CLASSNAMES, weights["params"], jax.random.key(3))
    noise = None
    if not case.get("ctx_init"):
        noise = torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(3), j_ctx.shape)))
    t_ctx, t_pre, t_suf, t_tok, t_n = tcoop.build_prompt_parts(
        tc, CLASSNAMES, weights["model"], noise=noise)
    assert t_n == j_n
    for got, expected in ((t_ctx, j_ctx), (t_pre, j_pre), (t_suf, j_suf),
                          (t_tok, j_tok)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    j_suf = jcoop.trim_prompt_parts(j_suf, j_tok, j_n)
    t_suf = tcoop.trim_prompt_parts(t_suf, t_tok, t_n)
    assert t_suf.shape == j_suf.shape and (1 + t_n + t_suf.shape[1]) % 8 == 0
    assert tcoop.trimmed_prompt_len(t_tok, t_n, 77 - 1 - t_n) == 1 + t_n + t_suf.shape[1]
    np.testing.assert_array_equal(
        tcoop.assemble_prompts(t_ctx, t_pre, t_suf, len(CLASSNAMES)).numpy(),
        np.asarray(jcoop.assemble_prompts(j_ctx, j_pre, j_suf, len(CLASSNAMES))))


def test_trim_can_be_switched_off(weights, monkeypatch):
    _, tc = _configs()
    _, _, suf, tok, n = tcoop.build_prompt_parts(
        tc, CLASSNAMES, weights["model"], generator=torch.Generator())
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_TRIM_PROMPTS", "0")
    assert tcoop.trim_prompt_parts(suf, tok, n).shape == suf.shape


def _cocoop_inputs(weights):
    """JAX and port CoCoOp parameters from the same draws, plus the prompt
    parts and normalised image features."""
    arch = weights["arch"]
    jc, tc = _configs(n_ctx=2)
    vis, ctx_dim = int(arch.embed_dim), int(arch.transformer_width)
    hidden = vis // 16
    keys = jax.random.split(jax.random.key(5), 4)
    shapes = {"meta_fc1": {"w": (vis, hidden), "b": (hidden,)},
              "meta_fc2": {"w": (hidden, ctx_dim), "b": (ctx_dim,)}}
    fan_in = {"meta_fc1": vis, "meta_fc2": hidden}
    uniforms, j_params, i = {}, {}, 0
    for layer, leaves in shapes.items():
        uniforms[layer], j_params[layer] = {}, {}
        bound = 1 / np.sqrt(fan_in[layer])
        for name, shape in leaves.items():
            uniforms[layer][name] = np.array(jax.random.uniform(keys[i], shape))
            # the JAX trainer's lin_init
            j_params[layer][name] = jax.random.uniform(
                keys[i], shape, minval=-bound, maxval=bound)
            i += 1
    t_params = tcocoop.init_meta_net(vis, ctx_dim, uniforms=uniforms)
    for layer in shapes:
        for name in shapes[layer]:
            np.testing.assert_allclose(t_params[layer][name].numpy(),
                                       np.asarray(j_params[layer][name]),
                                       rtol=0, atol=1e-7)
    j_ctx, j_pre, j_suf, j_tok, n = jcoop.build_prompt_parts(
        jc, CLASSNAMES, weights["params"], jax.random.key(6), force_shared_ctx=True)
    j_suf = jcoop.trim_prompt_parts(j_suf, j_tok, n)
    j_params["ctx"] = j_ctx
    t_params["ctx"] = torch.from_numpy(np.array(j_ctx))
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(6, vis)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    parts = (jnp.asarray(j_pre), jnp.asarray(j_suf), j_tok.argmax(axis=-1))
    return j_params, t_params, parts, feats


@pytest.mark.parametrize("budget", [10_000, 10, 3],
                         ids=["one-call", "image-chunks", "prompt-slices"])
def test_conditional_logits_match_jax(weights, monkeypatch, budget):
    arch, k, scale = weights["arch"], len(CLASSNAMES), 7.5
    j_params, t_params, (pre, suf, eot), feats = _cocoop_inputs(weights)
    labels = np.arange(feats.shape[0]) % k

    def j_loss(p):
        logits = jcocoop.conditional_logits(weights["params"], arch, p,
                                            jnp.asarray(feats), pre, suf, eot, k,
                                            scale)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1).mean(), logits

    (_, j_logits), j_grads = jax.value_and_grad(j_loss, has_aux=True)(j_params)

    monkeypatch.setattr(tcocoop, "PROMPT_BUDGET", budget)
    leaves = {"ctx": t_params["ctx"],
              **{f"{l}/{n}": t for l in ("meta_fc1", "meta_fc2")
                 for n, t in t_params[l].items()}}
    for t in leaves.values():
        t.requires_grad_(True)
    logits = tcocoop.conditional_logits(
        weights["model"], t_params, torch.from_numpy(feats),
        torch.from_numpy(np.array(pre)), torch.from_numpy(np.array(suf)),
        torch.from_numpy(np.array(eot)).long(), k, scale)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               rtol=0, atol=5e-5)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    expected = {"ctx": j_grads["ctx"],
                **{f"{l}/{n}": j_grads[l][n] for l in ("meta_fc1", "meta_fc2")
                   for n in ("w", "b")}}
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(expected[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# both CLIs end to end
# ---------------------------------------------------------------------------

CLI_CONFIGS = {
    "coop": ["--trainer", "Adapter-CoOp", "--ctx-init", "a photo of a"],
    "cocoop": ["--trainer", "Adapter-CoCoOp", "--n-ctx", "2",
               "TRAIN.PRINT_FREQ", "1"],
}


def _argv(root, out, weights, config):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "4", *CLI_CONFIGS[config],
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights),
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "2",
        "DATALOADER.NUM_WORKERS", "0",
        "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    base = tmp_path_factory.mktemp("cli")
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        initial = {}

        def record(build):  # the JAX run's initial CoCoOp parameters
            def wrapped(self):
                build(self)
                initial.update(jax.tree.map(np.asarray, self.params))
            return wrapped

        def inject(build):  # ... loaded into the port's trainer
            def wrapped(self):
                build(self)
                self.load_trainable_state(initial)
            return wrapped

        mp.setattr(jcocoop.Trainer, "build_model", record(jcocoop.Trainer.build_model))
        mp.setattr(tcocoop.Trainer, "build_model", inject(tcocoop.Trainer.build_model))
        for config in CLI_CONFIGS:
            for side, cli, reset in (("jax", jax_cli, jax_reset_tee),
                                     ("port", port_cli, port_reset_tee)):
                out = base / f"{config}-{side}"
                try:
                    cli.main(_argv(base / f"data-{side}", out, weights["path"],
                                   config))
                finally:
                    reset()
                with (out / "metrics.json").open() as f:
                    results[config, side] = {
                        "metrics": json.load(f),
                        "files": sorted(p.name for p in out.iterdir()),
                        "ckpt": dict(np.load(out / "adapter" / "model.ckpt-2.npz")),
                    }
    return results


def test_coop_cli_matches_jax(runs, weights):
    jax_run, port_run = runs["coop", "jax"], runs["coop", "port"]
    j, t = jax_run["metrics"], port_run["metrics"]
    assert t["method"] == j["method"] == "coop"
    assert t["metrics"]["top1_acc"] == j["metrics"]["top1_acc"]
    for key in METRICS:
        assert t["metrics"][key] == pytest.approx(j["metrics"][key], abs=1e-3), key
    for key in ("top1_acc", "ece", "aece"):
        assert t["zero_shot"][key] == pytest.approx(j["zero_shot"][key], abs=1e-3), key
    expected = jax_run["ckpt"]["state/ctx"]
    assert expected.shape == (4, 64)  # four words of the phrase
    np.testing.assert_allclose(port_run["ckpt"]["state/ctx"], expected,
                               rtol=0, atol=1e-4)
    start = tcoop.build_prompt_parts(_configs(ctx_init="a photo of a")[1],
                                     CLASSNAMES, weights["model"])[0]
    assert np.abs(expected - start.numpy()).max() > 1e-3  # it trained


@pytest.mark.parametrize("config", list(CLI_CONFIGS))
def test_prompt_cli_metrics_json_schema_matches_jax(runs, config):
    j, t = runs[config, "jax"], runs[config, "port"]
    assert set(t["metrics"]) == set(j["metrics"])
    assert set(t["metrics"]["metrics"]) == set(j["metrics"]["metrics"])
    assert set(t["metrics"]["config"]) == set(j["metrics"]["config"])
    assert (t["metrics"]["zero_shot"] is None) == (j["metrics"]["zero_shot"] is None)
    for key in METRICS:
        assert np.isfinite(t["metrics"]["metrics"][key]), key
    assert t["files"] == j["files"]
    assert set(t["ckpt"]) == set(j["ckpt"])
    for key, value in j["ckpt"].items():
        assert t["ckpt"][key].shape == value.shape, key


def test_cocoop_cli_trains_from_the_jax_init(runs):
    t = runs["cocoop", "port"]
    assert t["metrics"]["method"] == "cocoop"
    for key, value in t["ckpt"].items():
        if key.startswith("state/"):
            assert np.isfinite(value).all(), key
