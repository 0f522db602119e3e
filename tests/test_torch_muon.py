"""The port's Muon (``runtime/optim.py`` ``MuonWithAuxAdam``, ``ns5_keller``)
against the JAX package's ``_muon_with_aux_adam``.

- Trajectories: the same parameters and gradients (numpy, from a seed)
  through JAX ``EpochOptimizer(name="muon")`` + ``optax.apply_updates`` and
  the port's ``EpochOptimizer``, one step and five, over a tall (rows >
  cols) and a wide matrix, a 1-D bias, a 3-D and a 4-D leaf, with and
  without weight decay, and across an epoch boundary in two groups. The
  JAX suite's own tolerances (``tests/test_reference_executed_muon.py``):
  rtol 1e-5 / atol 1e-6 on the <2-D (Adam) leaves, atol 8e-3 on the rest,
  whose Newton–Schulz iteration runs in bf16 and whose matrix products
  round differently in torch and XLA.
- The closed-form anchors of ``tests/test_muon_anchors.py`` on the port's
  NS-5 and optimizer step, at that file's tolerances.
- bf16 NS-5 on a rank-deficient matrix: in exact arithmetic its output
  lies in the input's range; in bf16 both torch and XLA put amplified
  rounding noise off the range, of order 0.2 and different on each side,
  while the range components agree as on a full-rank input. An Adapter
  step's gradient of the visual projection has rank at most the batch
  size, so that noise is why the CLI's projections differ by far more than
  8e-3.
- The CLI: the Adapter (template logits, no GP) with ``OPTIM.NAME muon`` in
  both packages, 3 epochs at lr 0.05 on 8 training images. The template
  logits (full-rank gradients) agree within 8e-3; the visual projection
  (32x32, gradients of rank 8) does not (2.2e-2 of a move of 3.0e-2, the
  noise above). Each run's state, served by the port's predict entry,
  reproduces its CLI's top-1; the two states move each probability by less
  than 5e-3 (2.4e-3 here), and top-1 is held where the JAX state's top-2
  margin exceeds 1e-2, as ``tests/test_torch_serving.py`` holds the int8
  tower. Random weights put each of the four probabilities near 0.25, so
  seven of 24 images are such near ties and flip (top-1 25.0 against 29.2);
  ECE and AECE over 24 images follow the flips and are not compared.
"""

import inspect
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
for path in (REPO, REPO / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu.runtime import optim as jopt  # noqa: E402
from clip_gp_tpu_torch import predict as port_predict  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.runtime import optim as topt  # noqa: E402
from test_muon_anchors import (  # noqa: E402
    NS_A,
    NS_B,
    NS_C,
    _hand_one_muon_step_2x2,
    make_known_spectrum,
    ns5_scalar,
)

SHAPES = {"w_tall": (12, 5), "w_wide": (5, 12), "bias": (7,), "batched": (3, 4, 6),
          "conv": (4, 3, 2, 2)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(steps, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(steps)]


def _config(wd):
    return SimpleNamespace(name="muon", lr=0.02, weight_decay=wd, betas=(0.9, 0.999),
                           lr_scheduler="cosine", max_epoch=4)


def _jax_trajectory(params, grads, cfg, epoch_every=None):
    opt = jopt.EpochOptimizer(cfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    traj = []
    for i, g in enumerate(grads):
        if epoch_every and i and i % epoch_every == 0:
            state = opt.set_epoch(state, i // epoch_every)
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
        traj.append({k: np.asarray(v) for k, v in p.items()})
    return traj


def _port_trajectory(params, grads, cfg, epoch_every=None):
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    opt = topt.EpochOptimizer(cfg, list(tensors.values()))
    assert isinstance(opt.opt, topt.MuonWithAuxAdam)
    traj = []
    for i, g in enumerate(grads):
        if epoch_every and i and i % epoch_every == 0:
            opt.set_epoch(i // epoch_every)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        traj.append({k: t.detach().numpy().copy() for k, t in tensors.items()})
    return traj


def _assert_close(got, want, what):
    for k, w in want.items():
        if w.ndim < 2:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=8e-3,
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("wd", [0.1, 0.0], ids=["wd", "no_wd"])
@pytest.mark.parametrize("steps", [1, 5])
def test_trajectory_matches_jax(steps, wd):
    params, grads = _params(), _grads(steps)
    cfg = _config(wd)
    want = _jax_trajectory(params, grads, cfg, epoch_every=2)
    got = _port_trajectory(params, grads, cfg, epoch_every=2)
    for step, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, f"step {step}")
    moved = np.abs(got[-1]["w_tall"] - params["w_tall"]).max()
    assert moved > 1e-2  # the steps are far larger than the tolerance


def test_two_groups_follow_jax():
    """Base and GP groups at their own lr, as the Adapter builds them."""
    params, grads = _params(2), _grads(4, seed=3)
    cfg = _config(0.05)
    groups = {"base": ["w_tall", "bias"], "gp": ["w_wide", "batched", "conv"]}
    lrs = {"base": 0.02, "gp": 0.005}

    def label_fn(p):
        return {k: "base" if k in groups["base"] else "gp" for k in p}

    jo = jopt.MultiGroupOptimizer(cfg, lrs, label_fn)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = jo.init(p)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    to = topt.MultiGroupOptimizer(cfg, lrs, {g: [tensors[k] for k in ks]
                                             for g, ks in groups.items()})
    for i, g in enumerate(grads):
        if i == 2:
            state = jo.set_epoch(state, 1)
            to.set_epoch(1)
        updates, state = jo.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        to.step()
        _assert_close({k: t.detach().numpy() for k, t in tensors.items()},
                      {k: np.asarray(v) for k, v in p.items()}, f"step {i}")
    assert to.current_lrs == pytest.approx(jo.current_lrs, rel=1e-12)


def test_coefficients_are_the_published_tuple():
    src = inspect.getsource(topt.ns5_keller)
    assert "3.4445" in src and "4.7750" in src and "2.0315" in src
    assert abs((NS_A + NS_B + NS_C) - 0.7010) < 1e-12


def _ns5(x):
    return topt.ns5_keller(torch.tensor(x, dtype=torch.float32)).double().numpy()


def test_ns5_matches_scalar_polynomial_on_known_spectrum():
    x, u, v, sig = make_known_spectrum(6, [3.0, 2.0, 1.5, 1.0, 0.5, 0.25])
    want = (u * ns5_scalar(sig)) @ v.T
    got = _ns5(x)
    np.testing.assert_allclose(got, want, atol=0.15)
    assert np.mean(np.abs(got - want)) < 0.03


def test_tall_matrix_transpose_path_matches_scalar_polynomial():
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    v, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    sig = np.array([2.0, 1.0, 0.5])
    x = (u[:, :3] * sig) @ v.T  # 8×3 tall
    want = (u[:, :3] * ns5_scalar(sig)) @ v.T
    got = _ns5(x)
    np.testing.assert_allclose(got, want, atol=0.15)
    assert np.mean(np.abs(got - want)) < 0.03


def test_orthogonal_input_maps_to_scaled_self():
    n = 16
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    want = ns5_scalar(np.ones(n))[0] * q
    got = _ns5(q)
    np.testing.assert_allclose(got, want, atol=0.15)
    assert np.mean(np.abs(got - want)) < 0.03


@pytest.mark.parametrize("rank", [2, 8])
def test_ns5_rank_deficient_noise_lies_off_the_range(rank):
    rng = np.random.default_rng(rank)
    g = (rng.normal(size=(32, rank)) @ rng.normal(size=(rank, 32))).astype(np.float32)
    got = _ns5(g)
    want = np.asarray(jopt._ns5_keller(jnp.asarray(g)).astype(jnp.float32), np.float64)
    u, _, vt = np.linalg.svd(g.astype(np.float64))
    u, v = u[:, :rank], vt[:rank].T

    def on_range(x):
        return u @ (u.T @ x @ v) @ v.T

    diff = got - want
    # the range components agree as on a full-rank input (3.5e-2 at rank 32)
    assert np.abs(on_range(diff)).max() < 5e-2
    assert np.abs(on_range(want)).max() > 0.2
    # off the range, exact arithmetic gives zero; both sides give noise
    assert np.abs(diff - on_range(diff)).max() > 0.1
    assert np.abs(got - on_range(got)).max() > 0.1


def test_one_step_hand_algebra():
    """One step on a 2×2 Muon leaf and a 1-D Adam leaf, against the hand
    algebra of ``tests/test_muon_anchors.py`` (update = (w_before −
    w_after) / lr)."""
    wd, lr = 0.1, 0.5
    w = torch.eye(2) * 2.0
    b = torch.tensor([0.5, -0.5])
    opt = topt.MuonWithAuxAdam([w, b], lr=lr, weight_decay=wd, betas=(0.9, 0.999))
    w.grad = torch.diag(torch.tensor([1.0, 2.0]))
    b.grad = torch.tensor([3.0, -4.0])
    w0, b0 = w.clone(), b.clone()
    opt.step()
    want_diag, want_m = _hand_one_muon_step_2x2([1.0, 2.0])
    want_w = np.diag(want_diag) + wd * np.eye(2) * 2.0
    np.testing.assert_allclose(((w0 - w) / lr).double().numpy(), want_w, atol=0.05)
    np.testing.assert_allclose(opt.state[w]["exp_avg"].double().numpy(),
                               np.diag(want_m), atol=1e-7)
    want_b = np.array([3.0 / (3.0 + 1e-8), -4.0 / (4.0 + 1e-8)]) + wd * np.array([0.5, -0.5])
    np.testing.assert_allclose(((b0 - b) / lr).double().numpy(), want_b, rtol=1e-4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _argv(root, out, weights):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "2", "--optimizer", "muon", "--lr", "0.05",
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights), "OPTIM.WEIGHT_DECAY", "0.01",
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "3",
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "100",
        "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
    ]


def test_cli_adapter_with_muon_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    weights = tmp_path / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))
    runs = {}
    for side, cli, reset in (("jax", jax_cli, jax_reset_tee),
                             ("port", port_cli, port_reset_tee)):
        out = tmp_path / side
        try:
            cli.main(_argv(tmp_path / f"data-{side}", out, weights))
        finally:
            reset()
        runs[side] = (json.loads((out / "metrics.json").read_text()),
                      dict(np.load(out / "adapter" / "model.ckpt-3.npz")))
    (jm, jck), (pm, pck) = runs["jax"], runs["port"]
    assert pm["config"]["optim"]["name"] == "muon"
    # each run's state served by the same code (the port's predict entry)
    probs, top1 = {}, {}
    for side in ("jax", "port"):
        out = port_predict.main(["--model-dir", str(tmp_path / side), "--split", "test",
                                 "--topk", "4", "--output", str(tmp_path / f"{side}.json")])
        probs[side] = np.array([[t["prob"] for t in sorted(p["topk"], key=lambda t: t["label"])]
                                for p in out["predictions"]])
        top1[side] = out["summary"]["top1_acc"]
    assert top1["jax"] == pytest.approx(jm["metrics"]["top1_acc"], abs=1e-3)
    assert top1["port"] == pytest.approx(pm["metrics"]["top1_acc"], abs=1e-3)
    # the two states move each probability by at most 2.4e-3 here; with
    # random weights every test image sits near a four-way tie (each
    # probability about 0.25), so top-1 is held only where the JAX state's
    # top-2 margin exceeds 1e-2, as the int8 serving test holds it
    assert np.abs(probs["jax"] - probs["port"]).max() < 5e-3
    ranked = np.sort(probs["jax"], axis=1)
    clear = ranked[:, -1] - ranked[:, -2] > 1e-2
    np.testing.assert_array_equal(probs["port"].argmax(1)[clear],
                                  probs["jax"].argmax(1)[clear])
    # template_logits [K, M] takes a full-rank gradient: the JAX suite's 8e-3
    np.testing.assert_allclose(pck["state/template_logits"], jck["state/template_logits"],
                               rtol=0, atol=8e-3)
    assert np.abs(jck["state/template_logits"]).max() > 0.1
