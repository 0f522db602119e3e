"""CoCoOp: conditional prompt learning with a per-image meta-net
(ref: trainers/adapter_cocoop.py), as the JAX package's ``methods/cocoop.py``
implements it.

CoOp's shared context gets an image-conditioned shift: ``meta_net`` =
Linear(vis_dim → vis_dim/16) → ReLU → Linear(→ ctx_dim) maps each normalized
image feature to a context bias, and every image re-encodes all K class
prompts through the text tower, differentiated (K1/K2 forward, K4/K3
backward).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from clip_gp_tpu_torch.core.registry import TRAINER_REGISTRY
from clip_gp_tpu_torch.methods import common
from clip_gp_tpu_torch.methods.coop import PromptTrainer
from clip_gp_tpu_torch.models.clip_model import prompt_tower_dtype
from clip_gp_tpu_torch.ops.metrics import AverageMeter, compute_accuracy

# Most conditional prompts (images × classes) in one text-tower call, the
# JAX package's value. It bounds memory, not dispatches: under autograd each
# chunk (and each sub-slice of a chunk) is a ``torch.utils.checkpoint``
# segment, so the backward holds one chunk's saved block inputs at a time.
# Tests may override it.
PROMPT_BUDGET = 256


def init_meta_net(vis_dim: int, ctx_dim: int, generator=None,
                  uniforms: Optional[Dict] = None, device=None) -> Dict:
    """Meta-net parameters {meta_fc1, meta_fc2: {w, b}} in right-multiply
    form, every weight and bias drawn from U(±1/√fan_in) as torch's
    ``nn.Linear`` draws them (ref: adapter_cocoop.py:36-40). ``uniforms``
    (the same nested dict of U[0, 1) draws) replaces the ``generator``'s
    draws, so tests can feed the JAX package's."""
    hidden = max(1, vis_dim // 16)
    shapes = {
        "meta_fc1": {"w": (vis_dim, hidden), "b": (hidden,)},
        "meta_fc2": {"w": (hidden, ctx_dim), "b": (ctx_dim,)},
    }
    fan_in = {"meta_fc1": vis_dim, "meta_fc2": hidden}
    params: Dict = {}
    for layer, leaves in shapes.items():
        bound = 1.0 / math.sqrt(fan_in[layer])
        params[layer] = {}
        for name, shape in leaves.items():
            u = (torch.rand(shape, generator=generator, device=device)
                 if uniforms is None
                 else torch.as_tensor(uniforms[layer][name], device=device))
            # the scaling of jax.random.uniform(minval=-bound, maxval=bound)
            params[layer][name] = u.float() * (2 * bound) - bound
    return params


def _chunk_logits(model, feats_c, bias_c, ctx, prefix, suffix, eot, k, scale):
    """[C, K] logits of C images against their K conditional prompts."""
    c = feats_c.shape[0]
    dim = ctx.shape[-1]
    ctx_c = (ctx[None, None] + bias_c[:, None, None]).expand(c, k, *ctx.shape)
    prompts = torch.cat(
        [prefix[None].expand(c, *prefix.shape), ctx_c,
         suffix[None].expand(c, *suffix.shape)],
        dim=2,
    ).reshape(c * k, -1, dim)
    eot_ck = eot.repeat(c)
    dtype = prompt_tower_dtype()

    def tower(p, e):
        return model.text_features_from_embeddings(p, e, compute_dtype=dtype)

    n = c * k
    sub = max(1, int(PROMPT_BUDGET))
    if n > sub:
        # the image-axis chunk floors at one image, whose k prompts can
        # alone exceed the budget (k > PROMPT_BUDGET: SUN397, ImageNet):
        # slices of at most `sub` prompts, each its own checkpoint segment
        text = torch.cat([
            _segment(tower, prompts[i:i + sub], eot_ck[i:i + sub])
            for i in range(0, n, sub)
        ])
    else:
        text = tower(prompts, eot_ck)
    text = common.l2_normalize(text.reshape(c, k, -1))
    return scale * torch.einsum("cd,ckd->ck", feats_c, text)


def _segment(fn, *args):
    """``fn(*args)``, as a non-reentrant checkpoint segment when autograd
    records: its activations are recomputed in the backward instead of
    kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def conditional_logits(model, params, img_feats, prefix, suffix, eot, k, scale):
    """Per-image conditional-prompt logits: [B, D] normalized image features
    → [B, K] (ref: trainers/adapter_cocoop.py:70-82). Chunks of C images'
    K prompts go through one text-tower call each, C·K at most
    ``PROMPT_BUDGET`` (read at call time) unless one image's K prompts
    alone exceed it."""
    b = img_feats.shape[0]
    chunk = max(1, min(b, int(PROMPT_BUDGET) // max(k, 1)))
    fc1, fc2 = params["meta_fc1"], params["meta_fc2"]
    h = torch.relu(img_feats @ fc1["w"] + fc1["b"])
    bias = h @ fc2["w"] + fc2["b"]  # [B, ctx_dim]
    return torch.cat([
        _segment(
            lambda f, bi, ctx: _chunk_logits(model, f, bi, ctx, prefix, suffix,
                                             eot, k, scale),
            img_feats[lo:lo + chunk], bias[lo:lo + chunk], params["ctx"],
        )
        for lo in range(0, b, chunk)
    ])


@TRAINER_REGISTRY.register("Adapter-CoCoOp")
class Trainer(PromptTrainer):
    # CoCoOp always shares its context; the reference never reads csc here
    force_shared_ctx = True

    def build_model(self):
        ctx = self._build_prompt_learner()
        print("Building CoCoOp adapter")
        meta = init_meta_net(int(self.arch.embed_dim),
                             int(self.arch.transformer_width),
                             generator=self.keys.next(), device=self.device)
        self._set_params({"ctx": ctx, **meta})

    # ------------------------------------------------------------------
    def _logits(self, feats_norm):
        return conditional_logits(
            self.clip_model, self.params, feats_norm, self.token_prefix,
            self.token_suffix, self.eot, self.num_classes_k, self.logit_scale,
        )

    def predict_logits(self, features):
        with torch.no_grad():
            return self._logits(common.l2_normalize(features))

    def remap_trainable_state(self, state, extra, idx):
        return state  # ctx + meta-net are class-agnostic

    # ------------------------------------------------------------------
    def train(self):
        start_time = time.time()
        self.build_model()
        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
        self.after_train()
        print(f"Training completed in {time.time() - start_time:.2f} seconds")

    def eval_logits_labels(self, split: str = "test"):
        loader = self.test_loader if split == "test" else self.val_loader
        logits_all, labels_all = [], []
        for batch in loader:
            with torch.no_grad():
                logits_all.append(self._logits(self._encode_norm(batch["img"])))
            labels_all.append(batch["label"])
        return torch.cat(logits_all).cpu().numpy(), np.concatenate(labels_all)

    def run_epoch(self):
        losses = AverageMeter()
        loader = self.train_loader_x
        self.num_batches = len(loader)
        print_freq = int(self.config.train.print_freq)
        for self.batch_idx, batch in enumerate(loader):
            img_feats = self._encode_norm(batch["img"])
            labels = torch.from_numpy(batch["label"].astype(np.int64)).to(self.device)
            logits = self._logits(img_feats)
            loss = common.cross_entropy(logits, labels)
            self._step(loss)
            loss, logits = loss.detach(), logits.detach()
            losses.update(loss)
            meet_freq = (self.batch_idx + 1) % print_freq == 0
            if meet_freq or self.num_batches < print_freq:
                acc_train = compute_accuracy(logits.cpu().numpy(),
                                             batch["label"])[0]
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                    f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                    f"loss {float(loss):.4f} acc_train {acc_train:.4f}"
                )
        self.opt.set_epoch(self.epoch + 1)
        return float(losses.avg)
