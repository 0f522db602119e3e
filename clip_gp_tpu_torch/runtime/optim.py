"""Optimizers and LR schedules on ``torch.optim``, with the reference's
semantics (ref: utils/optimization.py) as the JAX package states them
(``clip_gp_tpu/runtime/optim.py``):

- "sgd" (momentum, optional nesterov) and "adam" couple weight decay into the
  gradient (L2); "adamw" decouples it — torch's own semantics for all three;
- schedules step per *epoch* (the reference calls ``sched.step()`` in
  ``after_epoch``): the schedule is a function of the epoch index and
  ``set_epoch`` writes the lr into each param group;
- parameter groups with their own base lr (base vs GP); a group whose lr is
  None is frozen and never stepped;
- "muon" is ``MuonWithAuxAdam``: ≥2-D parameters orthogonalize their
  momentum by a bf16 Newton–Schulz iteration, the others take Adam, the
  JAX package's ``_muon_with_aux_adam`` exactly.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


def _opt(config, name, default):
    """Scheduler knob with the reference's derived default: the config field
    may be absent OR None (None = "derive")."""
    v = getattr(config, name, None)
    return default if v is None else v


def build_lr_schedule(config, warmup: bool = False) -> Callable[[int], float]:
    """Return epoch → lr, mirroring build_lr_scheduler semantics
    (ref: utils/optimization.py:218-280, 283-369)."""
    name = str(getattr(config, "lr_scheduler", "constant")).lower()
    base_lr = float(config.lr)
    max_epoch = int(config.max_epoch)

    if name == "cosine":
        eta_min = float(_opt(config, "eta_min", 0.0))

        def sched(e):
            return eta_min + (base_lr - eta_min) * (
                1 + math.cos(math.pi * min(e, max_epoch) / max(max_epoch, 1))
            ) / 2

    elif name == "step":
        step_size = int(_opt(config, "step_size", max(max_epoch // 3, 1)))
        gamma = float(_opt(config, "gamma", 0.1))

        def sched(e):
            return base_lr * gamma ** (e // step_size)

    elif name == "multistep":
        milestones = list(
            _opt(config, "milestones", [max_epoch // 2, max_epoch * 3 // 4])
        )
        gamma = float(_opt(config, "gamma", 0.1))

        def sched(e):
            return base_lr * gamma ** sum(1 for m in milestones if e >= m)

    elif name == "exponential":
        gamma = float(_opt(config, "gamma", 0.95))

        def sched(e):
            return base_lr * gamma**e

    elif name == "constant":

        def sched(e):
            return base_lr

    elif name == "linear":
        start = float(_opt(config, "start_factor", 1.0))
        end = float(_opt(config, "end_factor", 0.0))
        total = int(_opt(config, "total_iters", max_epoch))

        def sched(e):
            t = min(e, total) / max(total, 1)
            return base_lr * (start + (end - start) * t)

    else:
        raise ValueError(f"Unsupported scheduler: {name}")

    if not warmup or int(getattr(config, "warmup_epoch", 0)) <= 0:
        return sched

    warmup_epochs = int(config.warmup_epoch)
    warmup_type = str(getattr(config, "warmup_type", "constant")).lower()
    warmup_factor = float(getattr(config, "warmup_cons_lr", 1e-5)) / base_lr

    def with_warmup(e):
        # the reference WarmupWrapper's intent, as the JAX package reads it:
        # epoch 0 at base lr, epochs 1..warmup_epochs-1 at the warmup factor,
        # then the inner schedule from sched(1) on
        if e == 0:
            return base_lr
        if e < warmup_epochs:
            if warmup_type == "constant":
                return base_lr * warmup_factor
            return base_lr * (warmup_factor + (1 - warmup_factor) * e / warmup_epochs)
        return sched(e - warmup_epochs + 1)

    return with_warmup


def build_torch_optimizer(config, groups: List[dict]) -> torch.optim.Optimizer:
    """The torch optimizer for ``config.name`` over param-group dicts (each
    with its "params" and "lr")."""
    name = str(config.name).lower()
    wd = float(getattr(config, "weight_decay", 0.0))
    betas = tuple(getattr(config, "betas", (0.9, 0.999)))
    eps = float(getattr(config, "eps", 1e-8))
    if name == "sgd":
        return torch.optim.SGD(
            groups, lr=groups[0]["lr"],
            momentum=float(getattr(config, "momentum", 0.9)),
            nesterov=bool(getattr(config, "nesterov", False)),
            weight_decay=wd, foreach=False,
        )
    if name == "adam":
        return torch.optim.Adam(groups, lr=groups[0]["lr"], betas=betas,
                                eps=eps, weight_decay=wd, foreach=False)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=groups[0]["lr"], betas=betas,
                                 eps=eps, weight_decay=wd, foreach=False)
    if name == "muon":
        return MuonWithAuxAdam(groups, lr=groups[0]["lr"], weight_decay=wd,
                               betas=betas)
    raise ValueError(f"Unsupported optimizer: {name}")


def ns5_keller(x: torch.Tensor, ns_steps: int = 5) -> torch.Tensor:
    """Newton–Schulz-5 orthogonalization with the public Muon package's
    numerics (github.com/KellerJordan/Muon ``zeropower_via_newtonschulz5``),
    as the JAX package's ``_ns5_keller``: the iteration in bfloat16, a
    transpose when rows > cols, Frobenius normalization with eps 1e-7, over
    the last two dims. Returns bf16; the caller casts."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = x.to(torch.bfloat16)
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.transpose(-1, -2)
    x = x / (torch.linalg.norm(x, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(ns_steps):
        xxt = x @ x.transpose(-1, -2)
        poly = b * xxt + c * (xxt @ xxt)
        x = a * x + poly @ x
    if transposed:
        x = x.transpose(-1, -2)
    return x


class MuonWithAuxAdam(torch.optim.Optimizer):
    """The reference's executed MuonWithAuxAdam (ref:
    utils/optimization.py:105-141 and the public Muon package it imports),
    as the JAX package's ``_muon_with_aux_adam`` states it:

    - ≥2-D parameters: momentum ``m ← βm + (1−β)g`` with β = 0.95 and no
      bias correction, the nesterov blend ``u = (1−β)g + βm``, bf16 NS-5
      (a 4-D parameter flattened to [rows, −1]), scaled by
      ``max(1, rows/cols)**0.5`` of the parameter's last two dims;
    - <2-D parameters: Adam with bias correction and eps 1e-8 added after
      the square root;
    - both: decoupled weight decay, ``p ← p − lr·(update + wd·p)``.

    The aux lr and weight decay are the Muon ones: the reference's aux knobs
    are unreachable in its config system. Every step is computed out of
    place in the JAX package's order, so fp32 rounding matches it."""

    # the Muon momentum and the Adam eps: constants in the reference's
    # executed config
    MOMENTUM = 0.95
    EPS = 1e-8

    def __init__(self, params, lr: float, weight_decay: float = 0.0, betas=(0.9, 0.999)):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=tuple(betas)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            b1, b2 = group["betas"]
            beta, eps = self.MOMENTUM, self.EPS
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    if p.ndim < 2:
                        state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                m = state["exp_avg"]
                if p.ndim >= 2:
                    m_new = beta * m + (1.0 - beta) * g
                    u = (1.0 - beta) * g + beta * m_new
                    flat = u.reshape(u.shape[0], -1) if u.ndim == 4 else u
                    ortho = ns5_keller(flat).reshape(g.shape).to(g.dtype)
                    factor = max(1.0, g.shape[-2] / g.shape[-1]) ** 0.5
                    update = ortho * factor + wd * p
                else:
                    v = state["exp_avg_sq"]
                    m_new = b1 * m + (1.0 - b1) * g
                    v_new = b2 * v + (1.0 - b2) * torch.square(g)
                    # bias corrections in float32, as the JAX package's
                    t = np.float32(state["step"])
                    m_hat = m_new / float(np.float32(1.0) - np.float32(b1) ** t)
                    v_hat = v_new / float(np.float32(1.0) - np.float32(b2) ** t)
                    update = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
                    v.copy_(v_new)
                m.copy_(m_new)
                p.add_(update * (-lr))
        return loss


class MultiGroupOptimizer:
    """Per-group lr schedules over one torch optimizer.

    The analog of build_optimizer_from_param_groups (ref:
    utils/optimization.py:147-…; ref: trainers/adapter.py:298-311):
    ``group_lrs`` maps a group name to its base lr (None = frozen: its
    tensors are never updated), ``group_params`` maps it to its tensors.
    """

    def __init__(self, config, group_lrs: Dict[str, Optional[float]],
                 group_params: Dict[str, Iterable[torch.Tensor]]):
        self.group_names = [g for g, lr in group_lrs.items() if lr is not None]
        self.schedules = {
            g: build_lr_schedule(_OverrideLr(config, group_lrs[g]))
            for g in self.group_names
        }
        groups = [
            {"params": list(group_params.get(g, [])), "lr": self.schedules[g](0),
             "name": g}
            for g in self.group_names
        ]
        groups = [g for g in groups if g["params"]]
        self.opt = build_torch_optimizer(config, groups) if groups else None
        self.current_lrs = {g: self.schedules[g](0) for g in self.group_names}

    def zero_grad(self) -> None:
        if self.opt is not None:
            self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update of every trainable tensor. A tensor the loss did not
        reach (``.grad`` None) gets a zero gradient, so weight decay still
        applies to it as optax's ``add_decayed_weights`` applies to every
        leaf; torch.optim would skip it."""
        if self.opt is None:
            return
        for pg in self.opt.param_groups:
            for p in pg["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.opt.step()

    def set_epoch(self, epoch: int) -> None:
        for group in self.group_names:
            self.current_lrs[group] = self.schedules[group](epoch)
        if self.opt is not None:
            for pg in self.opt.param_groups:
                pg["lr"] = self.current_lrs[pg["name"]]


class EpochOptimizer(MultiGroupOptimizer):
    """One-group optimizer with a host-side per-epoch lr schedule (optional
    warmup); ``set_epoch`` at each epoch boundary is the ``sched.step()``."""

    def __init__(self, config, params: Iterable[torch.Tensor], warmup: bool = False):
        super().__init__(config, {"base": float(config.lr)}, {"base": params})
        self.schedules["base"] = build_lr_schedule(config, warmup=warmup)
        self.set_epoch(0)

    @property
    def current_lr(self) -> float:
        return self.current_lrs["base"]


def cosine_decay(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(init_value, decay_steps)``: the lr of
    update ``t``, counted from 0 (optax's first update reads ``schedule(0)``)."""
    def sched(t: int) -> float:
        return init_value * 0.5 * (1 + math.cos(math.pi * min(t, decay_steps)
                                                / decay_steps))
    return sched


class StepAdamW:
    """``optax.adamw(schedule, eps=eps, weight_decay=weight_decay)`` on
    ``torch.optim.AdamW``, the lr set from ``schedule`` before every update.

    The two meet where their defaults differ: optax's ``adamw`` defaults to
    a weight decay of 1e-4 and torch's to 1e-2, so callers pass it; betas
    (0.9, 0.999) and eps 1e-8 are the same default in both, and ``eps`` is
    passed through verbatim (0 included). Both decouple the decay as
    ``p -= lr·wd·p`` beside the Adam step ``lr·m̂/(√v̂ + eps)``. Optax updates
    every leaf, so a tensor the loss did not reach gets a zero gradient here
    (its decay still applies), where torch would skip it."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                     eps=eps, weight_decay=weight_decay,
                                     foreach=False)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for pg in self.opt.param_groups:
            pg["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1


class _OverrideLr:
    """Config view with a different base lr (param-group override)."""

    def __init__(self, config, lr: float):
        self._config = config
        self.lr = lr

    def __getattr__(self, item):
        return getattr(self._config, item)
