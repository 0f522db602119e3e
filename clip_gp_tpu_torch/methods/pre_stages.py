"""Classifier pre-stages shared by CLIP-Adapter, TaskRes and Tip-Adapter
(JAX ``clip_gp_tpu/methods/pre_stages.py``).

Both stages work on cached, L2-normalized few-shot train features at the
fixed scale 100, one full-batch update per epoch, and produce replacement
class prototypes [K,D]:

- GP stage (ref: trainers/clip_adapter.py:234-294, taskres.py:209-293,
  tip_adapter.py:476-546): the variational GP template weighter trained with
  CE(mean-over-S logits) + β·KL for ``optim.max_epoch`` epochs under
  AdamW(gp_lr) with a cosine decay, then normalized MC-mean prototypes. This
  family's loss averages *logits* over samples before the CE (the Adapter
  averages per-sample CEs).
- Template-weight stage (ref: trainers/clip_adapter.py:296-333 etc.): [K,M]
  weight logits learned by CE on the cached features, with an optional
  L2-to-uniform regularizer (TaskRes, ref: taskres.py:339-349).

Optax's ``adamw`` with ``cosine_decay_schedule`` becomes
``runtime.optim.StepAdamW`` with ``cosine_decay``, read at the same update
index. The GP noise is an argument: by default it comes from the run's
``KeySequence``, drawn as the JAX package draws its keys (one per epoch out
of ``epochs + 1``, then one for the prototypes).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from clip_gp_tpu_torch.gp import svgp
from clip_gp_tpu_torch.methods import common
from clip_gp_tpu_torch.runtime.optim import StepAdamW, cosine_decay


def train_gp_stage(
    config,
    text_embeddings: torch.Tensor,
    train_features,
    train_labels,
    key_seq,
    warm_start_scale: Optional[float] = None,
    init_features=None,
    init_labels=None,
    eps: Optional[Sequence[torch.Tensor]] = None,
):
    """Returns (gp bundle (static, params, buffers), mean prototypes [K,D]).

    ``init_features``/``init_labels`` replace the features that score the
    warm start only (the prefit_on_full_set path; the GP still trains on the
    few-shot set, ref: adapter.py:71-100). ``eps`` holds the standard-normal
    draws: one [S_train, K, M] per epoch, then one [S_eval, K, M] for the
    prototypes; without it they come from ``key_seq``'s generators."""
    device = text_embeddings.device
    static, params, buffers = svgp.create_gp(text_embeddings, config, device)
    init_w = common.get_template_weights(
        config,
        text_embeddings,
        torch.as_tensor(init_features if init_features is not None
                        else train_features, dtype=torch.float32, device=device),
        torch.as_tensor(init_labels if init_labels is not None else train_labels,
                        dtype=torch.int64, device=device),
        warm_start_scale if warm_start_scale is not None else 100.0,
    )
    params = svgp.initialize_from_weights(params, init_w)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    epochs = int(config.optim.max_epoch)
    steps = max(epochs, 1)
    s_tr = max(1, int(config.adapter.gp_num_mc_samples_train or 1))
    s_eval = max(1, int(config.adapter.gp_num_mc_samples_eval or 1))
    beta_kl = float(config.adapter.gp_beta)
    feats = common.l2_normalize(
        torch.as_tensor(train_features, dtype=torch.float32, device=device))
    labels = torch.as_tensor(train_labels, dtype=torch.int64, device=device)
    opt = StepAdamW(params.values(),
                    cosine_decay(float(config.adapter.gp_lr), steps),
                    weight_decay=float(config.optim.weight_decay))

    # the key stream advances as the JAX package's does, injected noise or not
    gens = key_seq.next(steps + 1)
    history = []
    for ep in range(steps):
        opt.zero_grad()
        protos, _ = svgp.sample_prototypes(
            static, params, buffers, s_tr,
            eps=None if eps is None else eps[ep], generator=gens[ep])
        p = common.l2_normalize(protos)
        logits = 100.0 * torch.einsum("bd,skd->bsk", feats, p).mean(dim=1)
        ce = common.cross_entropy(logits, labels)
        kl = svgp.kl_divergence(params).sum()
        loss = ce + beta_kl * kl
        loss.backward()
        opt.step()
        acc = 100.0 * (logits.argmax(dim=-1) == labels).float().mean()
        history.append(torch.stack([loss, ce, kl, acc]).detach())
    for ep in (0, epochs - 1):
        if 0 <= ep < epochs:
            loss, ce, kl, acc = history[ep].tolist()
            print(f"[GP] epoch {ep + 1}/{epochs} loss={loss:.4f} CE={ce:.4f} "
                  f"KL={kl:.4f} acc={acc:.2f}")

    params = {k: v.detach() for k, v in params.items()}
    gen = key_seq.next()
    with torch.no_grad():
        protos, _ = svgp.sample_prototypes(
            static, params, buffers, s_eval,
            eps=None if eps is None else eps[steps], generator=gen)
        mean_protos = common.l2_normalize(protos.mean(dim=0))
    return (static, params, buffers), mean_protos


def train_template_weight_stage(
    config,
    text_embeddings: torch.Tensor,
    train_features,
    train_labels,
    l2_to_uniform_lambda: float = 0.0,
    n_batches: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learn [K,M] template-weight logits; returns (weights, prototypes [K,D]).

    ``n_batches`` sets the reference's cosine horizon: CosineAnnealingLR is
    built over ``epochs * len(train_loader)`` steps but stepped once per
    epoch (ref: taskres.py:327-353, clip_adapter.py:309-323,
    tip_adapter.py:180-206), so the lr stays near its start."""
    device = text_embeddings.device
    k, m = int(text_embeddings.shape[0]), int(text_embeddings.shape[1])
    epochs = int(config.optim.max_epoch)
    tw_logits = torch.zeros(k, m, device=device, requires_grad=True)
    feats = common.l2_normalize(
        torch.as_tensor(train_features, dtype=torch.float32, device=device))
    labels = torch.as_tensor(train_labels, dtype=torch.int64, device=device)
    e = text_embeddings
    opt = StepAdamW([tw_logits],
                    cosine_decay(float(config.optim.lr),
                                 max(1, epochs * max(1, int(n_batches)))),
                    weight_decay=float(config.optim.weight_decay))
    for _ in range(max(epochs, 1)):
        opt.zero_grad()
        weights = torch.softmax(tw_logits, dim=-1)
        protos = common.l2_normalize(torch.einsum("km,kmd->kd", weights, e))
        logits = 100.0 * feats @ protos.T
        loss = common.cross_entropy(logits, labels)
        if l2_to_uniform_lambda > 0 and m > 0:
            loss = loss + l2_to_uniform_lambda * ((weights - 1.0 / m) ** 2).mean()
        loss.backward()
        opt.step()
    acc = 100.0 * (logits.argmax(dim=-1) == labels).float().mean()
    print(f"[TW] epoch {epochs}/{epochs} loss={loss.item():.4f} "
          f"acc={float(acc):.2f}")
    with torch.no_grad():
        weights = torch.softmax(tw_logits, dim=-1)
        protos = common.l2_normalize(torch.einsum("km,kmd->kd", weights, e))
    return weights, protos
