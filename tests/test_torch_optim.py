"""Port optimizers and LR schedules against the JAX package.

``build_lr_schedule`` must give the JAX package's lr at every epoch, for
every scheduler with and without warmup. ``MultiGroupOptimizer`` over
torch.optim must follow the optax trajectory of the JAX one, step by step,
for sgd (momentum, coupled weight decay) and adamw (decoupled), with two
groups at their own lr and an epoch boundary that changes the lr. The loss is
a fixed quadratic, so both sides see the same gradients; fp32 updates agree
to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_gp_tpu.core.config import OptimConfig as JOptimConfig
from clip_gp_tpu.runtime import optim as jopt
from clip_gp_tpu_torch.core.config import OptimConfig as TOptimConfig
from clip_gp_tpu_torch.runtime import optim as topt

SCHEDULERS = ["cosine", "step", "multistep", "exponential", "constant", "linear"]


def _configs(**fields):
    return JOptimConfig(**fields), TOptimConfig(**fields)


def test_optim_config_fields_match():
    assert [f.name for f in dataclasses.fields(TOptimConfig)] == [
        f.name for f in dataclasses.fields(JOptimConfig)
    ]


@pytest.mark.parametrize("warmup", [False, True], ids=["plain", "warmup"])
@pytest.mark.parametrize("name", SCHEDULERS)
def test_lr_schedule_matches_jax(name, warmup):
    jc, tc = _configs(lr=0.02, max_epoch=12, lr_scheduler=name, warmup_epoch=3,
                      warmup_type="linear")
    j_sched = jopt.build_lr_schedule(jc, warmup=warmup)
    t_sched = topt.build_lr_schedule(tc, warmup=warmup)
    for epoch in range(15):
        assert t_sched(epoch) == pytest.approx(j_sched(epoch), rel=1e-12), epoch


def _init_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "visual_proj": rng.normal(size=(4, 4)).astype(np.float32),
        "gp": {
            "variational_mean": rng.normal(size=(3, 5)).astype(np.float32),
            "raw_lengthscale": rng.normal(size=(3,)).astype(np.float32),
        },
    }


def _targets(seed=1):
    return jax.tree.map(
        lambda a: np.random.default_rng(seed).normal(size=a.shape).astype(np.float32),
        _init_params(),
    )


def _jax_trajectory(config, group_lrs, steps, epoch_every):
    params = jax.tree.map(jnp.asarray, _init_params())
    targets = jax.tree.map(jnp.asarray, _targets())

    def label_fn(p):
        return {name: jax.tree.map(lambda _: "gp" if name == "gp" else "base", sub)
                for name, sub in p.items()}

    def loss(p):
        return sum(jnp.sum((a - t) ** 2 * (1 + a))
                   for a, t in zip(jax.tree.leaves(p), jax.tree.leaves(targets)))

    opt = jopt.MultiGroupOptimizer(config, group_lrs, label_fn)
    state = opt.init(params)
    out = []
    for step in range(steps):
        updates, state = opt.update(jax.grad(loss)(params), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        if (step + 1) % epoch_every == 0:
            state = opt.set_epoch(state, (step + 1) // epoch_every)
        out.append(jax.tree.map(np.asarray, params))
    return out


def _torch_trajectory(config, group_lrs, steps, epoch_every):
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()).requires_grad_(True),
                          _init_params())
    targets = jax.tree.map(torch.from_numpy, _targets())
    groups = {"base": [params["visual_proj"]], "gp": list(params["gp"].values())}
    opt = topt.MultiGroupOptimizer(config, group_lrs, groups)
    out = []
    for step in range(steps):
        opt.zero_grad()
        loss = sum(((a - t) ** 2 * (1 + a)).sum()
                   for a, t in zip(jax.tree.leaves(params), jax.tree.leaves(targets)))
        loss.backward()
        opt.step()
        if (step + 1) % epoch_every == 0:
            opt.set_epoch((step + 1) // epoch_every)
        out.append(jax.tree.map(lambda t: t.detach().numpy().copy(), params))
    return out


@pytest.mark.parametrize("name", ["sgd", "adamw", "adam"])
def test_multi_group_trajectory_matches_jax(name):
    jc, tc = _configs(name=name, lr=0.05, max_epoch=3, lr_scheduler="cosine",
                      weight_decay=0.01, momentum=0.9)
    group_lrs = {"base": 0.05, "gp": 0.01}
    expected = _jax_trajectory(jc, group_lrs, steps=6, epoch_every=2)
    got = _torch_trajectory(tc, group_lrs, steps=6, epoch_every=2)
    for step, (e, g) in enumerate(zip(expected, got)):
        for (path, ev), gv in zip(jax.tree_util.tree_leaves_with_path(e),
                                  jax.tree.leaves(g)):
            np.testing.assert_allclose(gv, ev, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {path}")
    # the trajectory moved: the comparison is not of the initial values
    assert np.abs(got[-1]["visual_proj"] - _init_params()["visual_proj"]).max() > 1e-2


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_unused_leaf_decays_as_optax(name):
    """A trainable tensor the loss never reaches still decays: optax's chain
    applies weight decay to its zero gradient, and the port must not skip it
    as torch.optim skips a tensor whose ``.grad`` is None."""
    import optax

    # optax's Adam bias correction runs in fp32 (1 - 0.999 errs by 1.3e-5
    # relative), torch's in double: a step of lr carries that difference,
    # so lr is small enough to keep it under rtol 1e-6 of the parameters
    lr = 0.002
    jc, tc = _configs(name=name, lr=lr, max_epoch=3, weight_decay=0.1,
                      momentum=0.9)
    rng = np.random.default_rng(0)
    init = {"used": rng.normal(size=(3, 4)).astype(np.float32),
            "unused": rng.normal(size=(5,)).astype(np.float32)}
    target = rng.normal(size=(3, 4)).astype(np.float32)

    tx = optax.chain(jopt._core_transform(jc), optax.scale(-lr))
    jparams = jax.tree.map(jnp.asarray, init)
    state = tx.init(jparams)
    jloss = lambda p: jnp.sum((p["used"] - target) ** 2)  # noqa: E731
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True)
               for k, v in init.items()}
    opt = topt.MultiGroupOptimizer(tc, {"base": lr}, {"base": list(tparams.values())})
    for step in range(3):
        updates, state = tx.update(jax.grad(jloss)(jparams), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        ((tparams["used"] - torch.from_numpy(target)) ** 2).sum().backward()
        opt.step()
        # the used leaf's values pass near zero, where fp32 rounding of the
        # two update orders differs by a few ulp of the step
        for key, atol in (("used", 1e-7), ("unused", 0.0)):
            np.testing.assert_allclose(tparams[key].detach().numpy(),
                                       np.asarray(jparams[key]), rtol=1e-6,
                                       atol=atol, err_msg=f"step {step} {key}")
    # the unused leaf moved toward zero on both sides
    assert np.all(np.abs(np.asarray(jparams["unused"])) < np.abs(init["unused"]))
    assert np.all(np.abs(tparams["unused"].detach().numpy()) < np.abs(init["unused"]))


def test_frozen_group_is_never_updated():
    _, tc = _configs(name="sgd", lr=0.1, max_epoch=2)
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3, requires_grad=True)
    opt = topt.MultiGroupOptimizer(tc, {"base": 0.1, "frozen": None},
                                   {"base": [a], "frozen": [b]})
    opt.zero_grad()
    (a.sum() + b.sum()).backward()
    opt.step()
    assert torch.all(a < 1) and torch.equal(b, torch.ones(3))


def test_epoch_optimizer_lr_follows_schedule():
    jc, tc = _configs(lr=0.1, max_epoch=4, lr_scheduler="cosine")
    p = torch.zeros(2, requires_grad=True)
    opt = topt.EpochOptimizer(tc, [p])
    j_sched = jopt.build_lr_schedule(jc)
    for epoch in range(5):
        opt.set_epoch(epoch)
        assert opt.current_lr == pytest.approx(j_sched(epoch))
        assert opt.opt.param_groups[0]["lr"] == pytest.approx(j_sched(epoch))


def test_muon_is_refused_until_ported():
    # Muon is ported (tests/test_torch_muon.py holds it against JAX): the
    # name now builds MuonWithAuxAdam instead of raising
    _, tc = _configs(name="muon")
    opt = topt.MultiGroupOptimizer(tc, {"base": 0.1}, {"base": [torch.zeros(2, 2)]})
    assert isinstance(opt.opt, topt.MuonWithAuxAdam)
