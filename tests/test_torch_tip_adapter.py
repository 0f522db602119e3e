"""Port Tip-Adapter and Tip-Adapter-F (``clip_gp_tpu_torch.methods.tip_adapter``)
against the JAX package.

- Both CLIs end to end on TEST-RN, the Synthetic dataset (which has a val
  split, so the (β, α) search runs), one npz and the same seed, no
  augmentation: Tip-Adapter and Tip-Adapter-F draw nothing at random, so
  top-1 must be equal and ECE/AECE within 1e-3 (percentage points, as
  tests/test_torch_train_e2e.py). Tip-Adapter-F runs at the config defaults:
  init β = α = 0 (the reference's quirk, which both packages guard by
  training at 1.0/1.0) and AdamW with eps = 0.
- Tip-Adapter-F on the GP pre-stage's classifier, on the port alone:
  finite metrics.
- The (β, α) grid search on the same inputs, with and without the -F keys,
  and where several cells tie: the same pick as the JAX package's.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.methods import tip_adapter as jtip  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.methods import tip_adapter as ttip  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES  # noqa: E402

METRICS = ("top1_acc", "ece", "aece")
CONFIGS = {
    "tip": ["--trainer", "Tip-Adapter"],
    "tip-f": ["--trainer", "Adapter-TipA-F", "TRAINER.ADAPTER.TIP_ADAPTER_EPOCHS", "3",
              "TRAINER.ADAPTER.TIP_ADAPTER_LR", "0.01"],
}
QUIRK = "[Tip-Adapter-F] init beta/alpha of 0 give the adapter no gradient"


def _argv(root, out, weights, opts):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-RN", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "3", *opts[:2],
        "INPUT.SIZE", "(64, 64)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights), *opts[2:],
        "DATALOADER.NUM_WORKERS", "0",
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
                    results[config, side] = {"metrics": json.load(f),
                                             "log": (out / "log.txt").read_text()}
        # the port alone: Tip-Adapter-F on the GP pre-stage's classifier
        out = base / "tip-f-gp-port"
        try:
            port_cli.main(_argv(base / "data-port", out, weights, CONFIGS["tip-f"] + [
                "TRAINER.ADAPTER.USE_GP", "True", "TRAINER.ADAPTER.GP_PCA_DIM", "8"]))
        finally:
            port_reset_tee()
        with (out / "metrics.json").open() as f:
            results["tip-f-gp", "port"] = {"metrics": json.load(f),
                                           "log": (out / "log.txt").read_text()}
    return results


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tip_cli_matches_jax(runs, config):
    j, t = runs[config, "jax"]["metrics"], runs[config, "port"]["metrics"]
    assert t["method"] == j["method"] == {"tip": "tipa", "tip-f": "tipaf"}[config]
    assert set(t) == set(j) and set(t["metrics"]) == set(j["metrics"])
    assert t["metrics"]["top1_acc"] == j["metrics"]["top1_acc"]
    for key in METRICS:
        assert t["metrics"][key] == pytest.approx(j["metrics"][key], abs=1e-3), key
        assert t["zero_shot"][key] == pytest.approx(j["zero_shot"][key], abs=1e-3), key
    quirk = config == "tip-f"
    assert (QUIRK in runs[config, "jax"]["log"]) == quirk
    assert (QUIRK in runs[config, "port"]["log"]) == quirk


def test_tip_f_on_the_gp_classifier_runs_on_the_port(runs):
    run = runs["tip-f-gp", "port"]
    assert run["metrics"]["method"] == "tipaf"
    for key in METRICS:
        assert np.isfinite(run["metrics"]["metrics"][key]), key
    assert "[Tip-Adapter] Using trained GP-based template weighter" in run["log"]


def _grid_inputs(seed, n_val=24, n_cache=12, k=4, d=16):
    """Val features scattered around cache keys (80% labelled as their key),
    a weak random zero-shot classifier and -F keys near the cache keys: the
    best (β, α) differs from seed to seed."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    keys = unit(rng.normal(size=(n_cache, d)))
    cache_labels = np.arange(n_cache) % k
    idx = rng.integers(0, n_cache, n_val)
    val = unit(keys[idx] + 3.0 * rng.normal(size=(n_val, d)) / np.sqrt(d))
    labels = np.where(rng.random(n_val) < 0.8, cache_labels[idx],
                      rng.integers(0, k, n_val)).astype(np.int32)
    return {"val": val, "labels": labels, "keys": keys, "cache_labels": cache_labels,
            "clip_weights": unit(rng.normal(size=(k, d))).T.copy(),
            "adapter_w": unit(keys + 0.3 * rng.normal(size=keys.shape) / np.sqrt(d)),
            "k": k}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("trained", [False, True], ids=["cache", "adapter-f"])
def test_grid_search_picks_the_jax_pick(seed, trained):
    x = _grid_inputs(seed)
    j = jtip.Trainer.__new__(jtip.Trainer)
    j.gp_bundle = None
    j.clip_weights = jnp.asarray(x["clip_weights"])
    j.cache_keys = jnp.asarray(x["keys"])
    j.cache_vals = jnp.eye(x["k"])[x["cache_labels"]]
    adapter_w = x["adapter_w"] if trained else None
    expected = j._search_hyperparams(
        x["val"], x["labels"], None if adapter_w is None else jnp.asarray(adapter_w))
    val = torch.from_numpy(x["val"])
    affinity = val @ torch.from_numpy(adapter_w if trained else x["keys"]).T
    got = ttip.search_hyperparams(
        100.0 * val @ torch.from_numpy(x["clip_weights"]), affinity,
        F.one_hot(torch.from_numpy(x["cache_labels"]), x["k"]).float(),
        torch.from_numpy(x["labels"]).long())
    assert got == expected


def test_grid_search_takes_the_first_of_tied_cells():
    """Cache logits too small to flip a prediction: every cell ties, and the
    first (β, α) wins in both packages."""
    x = _grid_inputs(5)
    clip_logits = 1e6 * x["val"] @ x["clip_weights"]
    j = jtip.Trainer.__new__(jtip.Trainer)
    j.gp_bundle = None
    j.clip_weights = jnp.asarray(1e4 * x["clip_weights"])
    j.cache_keys = jnp.asarray(x["keys"])
    j.cache_vals = jnp.eye(x["k"])[x["cache_labels"]]
    expected = j._search_hyperparams(x["val"], x["labels"])
    val = torch.from_numpy(x["val"])
    got = ttip.search_hyperparams(
        torch.from_numpy(clip_logits), val @ torch.from_numpy(x["keys"]).T,
        F.one_hot(torch.from_numpy(x["cache_labels"]), x["k"]).float(),
        torch.from_numpy(x["labels"]).long())
    assert got == expected == (ttip.BETAS[0], ttip.ALPHAS[0])
