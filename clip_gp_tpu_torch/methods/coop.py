"""CoOp: learnable prompt context vectors (ref: trainers/adapter_coop.py), as
the JAX package's ``methods/coop.py`` implements it.

n_ctx learnable context embeddings (shared, class-specific with ``csc``, or
initialized from a phrase with ``ctx_init``) are spliced between the SOS
embedding and the class-name suffix, and the assembled prompts re-encode
through the frozen text transformer every step: gradients flow through the
tower (K1/K2 forward, K4/K3 backward) to the context vectors only. The
image tower's output is a constant (ref: adapter_coop.py:514-522).

Each step is eager PyTorch with autograd. The JAX package advances its quiet
epochs as one scanned executable to save TPU dispatches; here every epoch
runs the eager loop, the same math.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from clip_gp_tpu_torch.core.registry import TRAINER_REGISTRY
from clip_gp_tpu_torch.data.templates import get_templates
from clip_gp_tpu_torch.methods import common
from clip_gp_tpu_torch.models.clip_model import prompt_tower_dtype
from clip_gp_tpu_torch.models.tokenizer import tokenize
from clip_gp_tpu_torch.ops.metrics import AverageMeter, compute_accuracy
from clip_gp_tpu_torch.runtime.optim import EpochOptimizer
from clip_gp_tpu_torch.runtime.trainer_base import BaseTrainer


def build_prompt_parts(config, classnames, model, generator=None, noise=None,
                       force_shared_ctx=False):
    """(ctx_vectors, token_prefix, token_suffix, tokenized, n_ctx) for prompt
    learning (ref: adapter_coop.py:453-502), on the model's device.

    The random context init is ``0.02 · noise``: ``noise`` (a standard-normal
    tensor of the context's shape) when given, so tests can feed the JAX
    draw, else a draw from ``generator``. ``force_shared_ctx`` ignores
    ``csc`` without mutating the config (CoCoOp always shares its context;
    the recorded config must still show the user's setting)."""
    n_ctx = int(config.adapter.n_ctx)
    ctx_init = str(config.adapter.ctx_init or "")
    use_csc = bool(config.adapter.csc) and not force_shared_ctx
    token_embedding = model.token_embedding.detach()
    device = token_embedding.device
    ctx_dim = token_embedding.shape[1]

    if ctx_init:
        phrase = ctx_init.replace("_", " ").strip()
        n_ctx = len(phrase.split(" "))
        tok = torch.from_numpy(tokenize(phrase)[0]).long().to(device)
        ctx_vectors = token_embedding[tok][1: 1 + n_ctx].clone()
        prompt_prefix = phrase
    else:
        shape = (len(classnames), n_ctx, ctx_dim) if use_csc else (n_ctx, ctx_dim)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"ctx noise must have shape {shape}")
        ctx_vectors = 0.02 * noise.to(device=device, dtype=torch.float32)
        prompt_prefix = " ".join(["X"] * n_ctx)

    prompts = [f"{prompt_prefix} {name}." for name in classnames]
    tokenized = torch.from_numpy(tokenize(prompts)).long().to(device)  # [K,77]
    embedding = token_embedding[tokenized]  # [K,77,dim]
    return (ctx_vectors, embedding[:, :1], embedding[:, 1 + n_ctx:], tokenized,
            n_ctx)


def trimmed_prompt_len(tokenized, n_ctx, token_suffix_width):
    """The assembled-prompt length ``trim_prompt_parts`` produces: the
    smallest multiple of 8 that covers every EOT position, at most the full
    1 + n_ctx + suffix width. ``CLIP_GP_TPU_TORCH_TRIM_PROMPTS=0`` keeps the
    full length."""
    full_len = 1 + n_ctx + token_suffix_width
    if os.environ.get("CLIP_GP_TPU_TORCH_TRIM_PROMPTS", "1") == "0":
        return full_len
    max_eot = int(tokenized.argmax(dim=-1).max())
    return min(full_len, -(-(max_eot + 1) // 8) * 8)


def trim_prompt_parts(token_suffix, tokenized, n_ctx):
    """Trim the prompt suffix so assembled prompts cover only the smallest
    8-aligned length that contains every EOT position. The text tower is
    causally masked, so the pooled feature at EOT is exactly the full-77
    computation's (reduction order aside) while the differentiated tower
    does about 77/L′ times less work (the JAX package's
    ``trim_prompt_parts``)."""
    lp = trimmed_prompt_len(tokenized, n_ctx, token_suffix.shape[1])
    return token_suffix[:, : max(1, lp - 1 - n_ctx)]


def assemble_prompts(ctx, token_prefix, token_suffix, num_classes):
    """[K, L, dim] prompt embeddings: SOS, the context (shared [n_ctx, dim]
    or per class [K, n_ctx, dim]), the class-name suffix."""
    if ctx.dim() == 2:
        ctx = ctx.unsqueeze(0).expand(num_classes, -1, -1)
    return torch.cat([token_prefix, ctx, token_suffix], dim=1)


class PromptTrainer(BaseTrainer):
    """What CoOp and CoCoOp share: the CLIP load, the prompt parts, the
    normalised image encode and the optimizer over ``self.params``."""

    force_shared_ctx = False

    def _build_prompt_learner(self):
        config = self.config
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {config.model.backbone_name})")
        self.arch, self.clip_model = self.load_clip_model()
        self.logit_scale = float(np.exp(self.clip_model.logit_scale.item()))
        ctx, self.token_prefix, suffix, self.tokenized, self.n_ctx = (
            build_prompt_parts(config, classnames, self.clip_model,
                               generator=self.keys.next(),
                               force_shared_ctx=self.force_shared_ctx)
        )
        self.token_suffix = trim_prompt_parts(suffix, self.tokenized, self.n_ctx)
        self.eot = self.tokenized.argmax(dim=-1)
        self.num_classes_k = len(classnames)
        return ctx

    def _set_params(self, params: Dict) -> None:
        """Adopt ``params`` (nested dict of tensors) as the trainable state
        and start a fresh optimizer over it."""
        self.params = params
        leaves = []
        for value in params.values():
            for leaf in value.values() if isinstance(value, dict) else [value]:
                leaf.requires_grad_(True)
                leaves.append(leaf)
        self.opt = EpochOptimizer(self.config.optim, leaves)

    def load_trainable_state(self, state: Dict) -> None:
        def adopt(v):
            if isinstance(v, dict):
                return {k: adopt(x) for k, x in v.items()}
            if not isinstance(v, torch.Tensor):
                v = torch.tensor(np.asarray(v))
            return v.detach().to(self.device, torch.float32).clone()

        self._set_params(adopt(state))

    def trainable_state(self):
        return self.params

    def _encode_norm(self, images_u8: np.ndarray) -> torch.Tensor:
        """L2-normalised fp32 image features of a uint8 NHWC batch."""
        images = torch.from_numpy(images_u8).to(self.device)
        with torch.no_grad():
            return common.l2_normalize(
                self.clip_model.encode_image(self.preprocess(images))
            )

    def _step(self, loss: torch.Tensor) -> None:
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()


@TRAINER_REGISTRY.register("Adapter-CoOp")
class Trainer(PromptTrainer):
    def build_model(self):
        ctx = self._build_prompt_learner()
        print("Building CoOp adapter")
        self._set_params({"ctx": ctx})
        # zero-shot classifier for the baseline block
        self.templates = get_templates(self.config)
        self.text_embeddings = common.encode_templates(
            self.clip_model, self.dm.dataset.classnames, self.templates
        )

    # ------------------------------------------------------------------
    def _text_features(self, ctx) -> torch.Tensor:
        """Normalised text features of the K prompts with context ``ctx``."""
        prompts = assemble_prompts(ctx, self.token_prefix, self.token_suffix,
                                   self.num_classes_k)
        feats = self.clip_model.text_features_from_embeddings(
            prompts, self.eot, compute_dtype=prompt_tower_dtype()
        )
        return common.l2_normalize(feats)

    def predict_logits(self, features):
        with torch.no_grad():
            text = self._text_features(self.params["ctx"])
            return self.logit_scale * common.l2_normalize(features) @ text.T

    def eval_logits_labels(self, split: str = "test"):
        if split == "test" and hasattr(self, "features_test"):
            logits = self.predict_logits(self._features_test_dev)
            return logits.cpu().numpy(), self.labels_test
        return super().eval_logits_labels(split)

    def remap_trainable_state(self, state, extra, idx):
        ctx = np.asarray(state["ctx"])
        if ctx.ndim == 3:  # class-specific ctx [K, n_ctx, dim]
            return {"ctx": ctx[idx]}
        return state  # unified ctx is class-agnostic

    # ------------------------------------------------------------------
    def train(self):
        start_time = time.time()
        self.build_model()

        # zero-shot baseline + cached normalized test features
        self.features_test, self.labels_test = common.extract_with(
            self._encode_norm, self.test_loader
        )
        self._features_test_dev = torch.from_numpy(self.features_test).to(self.device)
        zs_w = common.zero_shot_classifier(self.text_embeddings)
        zs_logits = (100.0 * self._features_test_dev @ zs_w).cpu().numpy()
        self.compute_zero_shot_block(zs_logits, self.labels_test)

        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
        self.after_train()
        print(f"Training completed in {time.time() - start_time:.2f} seconds")

    def _train_step(self, img_feats, labels):
        text = self._text_features(self.params["ctx"])
        logits = self.logit_scale * img_feats @ text.T
        loss = common.cross_entropy(logits, labels)
        self._step(loss)
        return loss.detach(), logits.detach()

    def run_epoch(self):
        losses = AverageMeter()
        loader = self.train_loader_x
        self.num_batches = len(loader)
        verbose = self.epoch == 0 or (self.epoch + 1) % 10 == 0
        for self.batch_idx, batch in enumerate(loader):
            img_feats = self._encode_norm(batch["img"])
            labels = torch.from_numpy(batch["label"].astype(np.int64)).to(self.device)
            loss, logits = self._train_step(img_feats, labels)
            losses.update(loss)
            if verbose:
                acc_train = compute_accuracy(logits.cpu().numpy(), batch["label"])[0]
                acc_test = compute_accuracy(
                    self.predict_logits(self._features_test_dev).cpu().numpy(),
                    self.labels_test,
                )[0]
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                    f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                    f"loss {float(loss):.4f} acc_train {acc_train:.4f} "
                    f"acc_test {acc_test:.4f}"
                )
        self.opt.set_epoch(self.epoch + 1)
        return float(losses.avg)
