"""The GP side of the port's trial-batched runner against the JAX package's,
fed the JAX package's own normal draws (``jax.random`` and
``torch.Generator`` streams differ by construction).

- ``TrialGP``: T trials folded into one ``svgp`` batch of T·K classes give
  each trial's single-trial predictive, KL and prototypes; a trial whose
  Gram needs the jitter fallback leaves its neighbours bit for bit as they
  were (the per-matrix probe of ``svgp.safe_cholesky``).
- The GP and template-weight pre-stages (``vmapped_gp_prestage`` in both
  mean modes and on the normalized templates, ``vmapped_tw_prestage`` with
  the L2-to-uniform term) on the same features: prototypes within 1e-4,
  GP parameters within 1e-3.

Whole GP runs through both runners are in
``tests/test_torch_trial_vmap_gp_runs.py``.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
for p in (REPO, TESTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from clip_gp_tpu.core.config import Config as JConfig  # noqa: E402
from clip_gp_tpu.parallel import trial_vmap as jtv  # noqa: E402
from clip_gp_tpu_torch.core.config import Config as TConfig  # noqa: E402
from clip_gp_tpu_torch.gp import svgp as tsvgp  # noqa: E402
from clip_gp_tpu_torch.parallel import trial_specs as tspecs  # noqa: E402
TOL = 1e-4
PARAM_TOL = 1e-3


def _normal(keys, shape) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, tuple(shape)))
                                      for k in keys]))


def jax_draws(seeds, n_batches=1, epochs=1, prestage_epochs=1):
    """The JAX runner's draws as the port's ``draws(kind, index, shape)``:
    the train keys split per epoch from ``key(seeds[0])`` into
    [n_batches, T], the eval keys split after them, the zero-shot keys from
    ``key(0)``, and the pre-stage keys folded from ``key(1000)`` and
    ``key(2000)`` per seed (``clip_gp_tpu/parallel/trial_vmap.py``)."""
    t = len(seeds)
    root = jax.random.key(int(seeds[0]))
    train = []
    for _ in range(epochs):
        root, sub = jax.random.split(root)
        train.extend(list(jax.random.split(sub, n_batches * t).reshape(n_batches, t)))
    root, sub = jax.random.split(root)
    keys = {
        "eval": jax.random.split(sub, t),
        "zero_shot": jax.random.split(jax.random.key(0), t),
        "prestage_protos": [jax.random.fold_in(jax.random.key(2000), int(s))
                            for s in seeds],
    }
    pre = [jax.random.split(jax.random.fold_in(jax.random.key(1000), int(s)),
                            prestage_epochs) for s in seeds]

    def draws(kind, index, shape):
        if kind == "train":
            return _normal(train[index], shape)
        if kind == "prestage":
            return _normal([p[index] for p in pre], shape)
        return _normal(keys[kind], shape)

    return draws


# ----------------------------------------------------------------------
# TrialGP
# ----------------------------------------------------------------------

def _gp_inputs(t_trials=3, k=4, m=5, d=16, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(k, m, d)).astype(np.float32)
    cfg = TConfig()
    cfg.adapter.gp_pca_dim = 6
    static, p0, buffers = tsvgp.create_gp(e, cfg, "cpu")
    params = tspecs.broadcast_trials(p0, t_trials)
    # each trial its own parameters
    params = {n: v + 0.05 * torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
              for n, v in params.items()}
    return static, buffers, params, rng


def test_trial_gp_folds_each_trial_alone():
    static, buffers, params, rng = _gp_inputs()
    gp = tspecs.TrialGP(static, buffers, 3)
    eps = torch.from_numpy(rng.normal(size=(3, 7, 4, 5)).astype(np.float32))
    protos = gp.sample_prototypes(params, eps)
    kl = gp.kl(params)
    for t in range(3):
        p_t = {n: v[t] for n, v in params.items()}
        want, _ = tsvgp.sample_prototypes(static, p_t, buffers, 7, eps=eps[t])
        np.testing.assert_allclose(protos[t].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(kl[t].item(), tsvgp.kl_divergence(p_t).sum().item(),
                                   rtol=1e-5)


def test_trial_gp_bad_gram_stays_in_its_trial():
    """Trial 1's lengthscales collapse its Gram onto the jitter fallback;
    trials 0 and 2 come out bit for bit as with a healthy trial 1."""
    static, buffers, params, rng = _gp_inputs()
    gp = tspecs.TrialGP(static, buffers, 3)
    eps = torch.from_numpy(rng.normal(size=(3, 5, 4, 5)).astype(np.float32))
    healthy = gp.sample_prototypes(params, eps)
    bad = dict(params)
    bad["raw_lengthscale"] = params["raw_lengthscale"].clone()
    bad["raw_lengthscale"][1] = 30.0  # a near-constant kernel: K_zz singular
    broken = gp.sample_prototypes(bad, eps)
    assert torch.isfinite(broken).all()
    for t in (0, 2):
        assert torch.equal(broken[t], healthy[t])


# ----------------------------------------------------------------------
# the pre-stages
# ----------------------------------------------------------------------

def _prestage_inputs(t_trials=2, k=4, m=3, d=16, n=8):
    rng = np.random.default_rng(3)
    e = rng.normal(size=(k, m, d)).astype(np.float32)
    feats = rng.normal(size=(t_trials, n, d)).astype(np.float32)
    labels = np.stack([rng.permutation(np.arange(n) % k) for _ in range(t_trials)])
    configs = []
    for cls in (JConfig, TConfig):
        c = cls()
        c.adapter.gp_pca_dim = 8
        c.adapter.gp_num_mc_samples_train = 4
        c.adapter.gp_num_mc_samples_eval = 8
        c.adapter.gp_lr = 0.05
        c.adapter.gp_beta = 0.01
        c.adapter.template_init_method = "minmax"
        c.optim.max_epoch = 5
        c.optim.lr = 0.05
        c.optim.weight_decay = 1e-3
        c.dataloader.batch_size_train = 4
        configs.append(c)
    seeds = [3, 5]
    jr = SimpleNamespace(config=configs[0], text_embeddings=jnp.asarray(e), shared={},
                         t_trials=t_trials, logit_scale=100.0, seeds=seeds, k=k, m=m)
    tr = SimpleNamespace(config=configs[1], text_embeddings=torch.from_numpy(e),
                         t_trials=t_trials, logit_scale=100.0, device=torch.device("cpu"),
                         draws=jax_draws(seeds, prestage_epochs=5), k=k, m=m)
    return jr, tr, e, feats, labels


@pytest.mark.parametrize("mode", ["norm_of_raw_mean", "mean_of_norm", "normalized-e"])
def test_gp_prestage_matches_jax(mode):
    jr, tr, e, feats, labels = _prestage_inputs()
    kw_j, kw_t = {}, {}
    if mode == "normalized-e":
        en = e / np.linalg.norm(e, axis=-1, keepdims=True)
        kw_j, kw_t = {"text_embeddings": jnp.asarray(en)}, {"text_embeddings": torch.from_numpy(en)}
    else:
        kw_j = kw_t = {"mean_mode": mode}
    _, jparams, jprotos = jtv.vmapped_gp_prestage(jr, jnp.asarray(feats),
                                                  jnp.asarray(labels), **kw_j)
    _, tparams, tprotos = tspecs.vmapped_gp_prestage(tr, torch.from_numpy(feats),
                                                     torch.from_numpy(labels), **kw_t)
    np.testing.assert_allclose(tprotos.numpy(), np.asarray(jprotos), atol=TOL, rtol=0)
    # Adam divides each step by the gradient's running RMS, so an element
    # whose gradient is a few ulps of fp32 noise moves by a part of the lr
    # in either package: the parameters are held to PARAM_TOL
    for name in ("variational_mean", "chol_variational_covar", "raw_lengthscale"):
        np.testing.assert_allclose(tparams[name].numpy(), np.asarray(jparams[name]),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_tw_prestage_matches_jax(lam):
    jr, tr, e, feats, labels = _prestage_inputs()
    jprotos = jtv.vmapped_tw_prestage(jr, jnp.asarray(feats), jnp.asarray(labels),
                                      l2_to_uniform_lambda=lam)
    tprotos = tspecs.vmapped_tw_prestage(tr, torch.from_numpy(feats),
                                         torch.from_numpy(labels),
                                         l2_to_uniform_lambda=lam)
    np.testing.assert_allclose(tprotos.numpy(), np.asarray(jprotos), atol=TOL, rtol=0)
