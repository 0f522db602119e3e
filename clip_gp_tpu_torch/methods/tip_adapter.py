"""Tip-Adapter and Tip-Adapter-F: the training-free cache classifier
(ref: trainers/tip_adapter.py; JAX ``methods/tip_adapter.py``).

Cache keys are the normalized few-shot features [N,D], values their one-hot
labels [N,K]; ``cache_logits = exp(−β(1−keyᵀq)) @ vals`` and
``tip_logits = clip_logits + α·cache_logits``. The -F variant makes the keys a
trainable bias-free linear layer initialized from the cache, trained with CE
(re-encoding its few-shot images every step) while the best test state is
kept. (β, α) are searched on the val set (β ∈ {1,2,5}, α ∈ {1,5,10,20,50})
in one tensor expression over the grid. ``train()`` is custom: no epoch
lifecycle (ref: tip_adapter.py:82-362).

Deliberately narrower than the JAX package, which falls back to the init
(β, α) on any exception of the val search: here only a run without a val
split falls back; an error of the encode or the search propagates.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from clip_gp_tpu_torch.core.registry import TRAINER_REGISTRY
from clip_gp_tpu_torch.data.templates import get_templates
from clip_gp_tpu_torch.gp import svgp
from clip_gp_tpu_torch.methods import common, pre_stages
from clip_gp_tpu_torch.ops.metrics import (
    AverageMeter,
    compute_accuracy,
    compute_aece,
    compute_aece_with_bins,
    compute_ece,
    compute_ece_with_bins,
)
from clip_gp_tpu_torch.runtime.optim import StepAdamW, cosine_decay
from clip_gp_tpu_torch.runtime.trainer_base import BaseTrainer

BETAS = (1.0, 2.0, 5.0)
ALPHAS = (1.0, 5.0, 10.0, 20.0, 50.0)


def cache_logits(affinity: torch.Tensor, cache_vals: torch.Tensor, beta) -> torch.Tensor:
    """exp(−(β − β·affinity)) @ values, in the JAX package's order."""
    return torch.exp(-(beta - beta * affinity)) @ cache_vals


def search_hyperparams(clip_logits: torch.Tensor, affinity: torch.Tensor,
                       cache_vals: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[float, float]:
    """The (β, α) of BETAS × ALPHAS with the best accuracy of
    ``clip_logits + α·cache_logits`` (ref: tip_adapter.py:438-466), the whole
    grid as one expression; the first maximum wins, as ``np.argmax``."""
    betas = torch.tensor(BETAS, device=affinity.device)[:, None, None]
    alphas = torch.tensor(ALPHAS, device=affinity.device)[None, :, None, None]
    cache = cache_logits(affinity[None], cache_vals, betas)  # [B, N, K]
    tip = clip_logits[None, None] + alphas * cache[:, None]  # [B, A, N, K]
    accs = (tip.argmax(dim=-1) == labels).float().mean(dim=-1).cpu().numpy()
    bi, ai = np.unravel_index(np.argmax(accs), accs.shape)
    return BETAS[bi], ALPHAS[ai]


@TRAINER_REGISTRY.register("Tip-Adapter")
class Trainer(BaseTrainer):
    def build_model(self):
        config = self.config
        print(f"Loading CLIP (backbone: {config.model.backbone_name})")
        self.arch, model = self.load_clip_model()
        self.classnames = self.dm.dataset.classnames
        self.templates = get_templates(config)
        self.text_embeddings = common.encode_templates(model, self.classnames,
                                                       self.templates)
        self.clip_weights = common.zero_shot_classifier(self.text_embeddings)
        self.gp_bundle = None

    def _encode_norm(self, images_u8: np.ndarray) -> torch.Tensor:
        images = torch.from_numpy(images_u8).to(self.device)
        with torch.no_grad():
            return common.l2_normalize(
                self.clip_model.encode_image(self.preprocess(images)))

    def _extract_norm(self, loader):
        """(normalized features [N,D] on the device, labels [N] numpy)."""
        feats, labels = common.extract_with(self._encode_norm, loader)
        return torch.from_numpy(feats).to(self.device), labels

    # ------------------------------------------------------------------
    def _clip_logits(self, feats: torch.Tensor) -> torch.Tensor:
        if self.gp_bundle is not None:
            static, gp_params, buffers = self.gp_bundle
            s = max(1, int(self.config.adapter.gp_num_mc_samples_eval or 1))
            with torch.no_grad():
                protos, _ = svgp.sample_prototypes(static, gp_params, buffers, s,
                                                   generator=self.keys.next())
            p = common.l2_normalize(protos)
            return 100.0 * torch.einsum("bd,skd->bsk", feats, p).mean(dim=1)
        return 100.0 * feats @ self.clip_weights

    def _affinity(self, feats, adapter_w=None):
        return feats @ (self.cache_keys if adapter_w is None else adapter_w).T

    def _tip_logits(self, feats, beta, alpha, adapter_w=None):
        cache = cache_logits(self._affinity(feats, adapter_w), self.cache_vals, beta)
        return self._clip_logits(feats) + alpha * cache

    # ------------------------------------------------------------------
    def train(self):
        start_time = time.time()
        self.build_model()
        config = self.config

        use_gp = bool(config.adapter.use_gp)
        use_tw = bool(config.adapter.tip_adapter_use_template_weight_training)
        tr_feats = tr_labels = None
        if use_gp or use_tw:
            tr_feats, tr_labels = self._extract_norm(self.train_loader_x)
            # Tip L2-normalizes each template embedding before the pre-stage
            # (ref: tip_adapter.py:98-103), like TaskRes's GP branch and
            # unlike CLIP-Adapter's raw E
            norm_embeddings = common.l2_normalize(self.text_embeddings)
            if use_gp:
                prefit = common.prefit_full_set_features(config, self)
                self.gp_bundle, _ = pre_stages.train_gp_stage(
                    config, norm_embeddings, tr_feats, tr_labels, self.keys,
                    init_features=prefit[0] if prefit else None,
                    init_labels=prefit[1] if prefit else None,
                )
                print("[Tip-Adapter] Using trained GP-based template weighter "
                      "for prototypes.")
            else:
                _, protos = pre_stages.train_template_weight_stage(
                    config, norm_embeddings, tr_feats, tr_labels,
                    n_batches=max(1, len(self.train_loader_x)),
                )
                self.clip_weights = protos.T

        # test features + zero-shot
        test_feats, test_labels = self._extract_norm(self.test_loader)
        self.features_test, self.labels_test = test_feats, test_labels
        with torch.no_grad():
            clip_logits_test = self._clip_logits(test_feats).cpu().numpy()
        self.compute_zero_shot_block(clip_logits_test, test_labels)

        # the cache: the pre-stage's extraction when there was one (one
        # frozen-tower pass instead of the reference's two)
        if tr_feats is None:
            tr_feats, tr_labels = self._extract_norm(self.train_loader_x)
        self.cache_keys = tr_feats  # [N,D]
        self.cache_vals = F.one_hot(
            torch.from_numpy(tr_labels.astype(np.int64)).to(self.device),
            len(self.classnames)).float()

        adapter_w: Optional[torch.Tensor] = None
        if bool(config.adapter.tip_adapter_trainable):
            adapter_w = self._train_adapter_f(test_feats, test_labels)

        if self.val_loader is None:
            print("[Tip-Adapter] val search unavailable (no val split); "
                  "using init values")
            beta = float(config.adapter.tip_adapter_init_beta)
            alpha = float(config.adapter.tip_adapter_init_alpha)
        else:
            val_feats, val_labels = self._extract_norm(self.val_loader)
            with torch.no_grad():
                beta, alpha = search_hyperparams(
                    self._clip_logits(val_feats),
                    self._affinity(val_feats, adapter_w), self.cache_vals,
                    torch.from_numpy(val_labels.astype(np.int64)).to(self.device))
        self.best_beta, self.best_alpha = beta, alpha
        self.adapter_w = adapter_w

        # final test
        with torch.no_grad():
            logits = self._tip_logits(test_feats, beta, alpha,
                                      adapter_w).cpu().numpy()
        acc = compute_accuracy(logits, test_labels)[0]
        print("Evaluate on the *test* set")
        print("=> result")
        print(f"* total: {len(test_labels):,}")
        print(f"* correct: {int((logits.argmax(1) == test_labels).sum()):,}")
        print(f"* accuracy: {acc:.1f}%")
        print(f"* error: {100 - acc:.1f}%")
        ece = compute_ece(logits, test_labels)
        aece = compute_aece(logits, test_labels)
        print(f"* ECE: {ece:.2f}%")
        print(f"* AECE: {aece:.2f}%")
        _, ece_bins = compute_ece_with_bins(logits, test_labels)
        _, aece_bins = compute_aece_with_bins(logits, test_labels)
        metrics = {
            "top1_acc": float(acc),
            "ece": float(ece),
            "aece": float(aece),
            "calibration": ece_bins,
            "adaptive_calibration": aece_bins,
        }
        self.write_run_summary_json(metrics, start_time=start_time)
        print(f"Completed in {time.time() - start_time:.2f} seconds")

    # ------------------------------------------------------------------
    def _train_adapter_f(self, test_feats, test_labels) -> torch.Tensor:
        """Tip-Adapter-F: trainable cache keys (ref: tip_adapter.py:613-682)."""
        config = self.config
        adapter_w = self.cache_keys.clone().requires_grad_(True)
        lr = float(config.adapter.tip_adapter_lr)
        epochs = int(config.adapter.tip_adapter_epochs)
        beta = float(config.adapter.tip_adapter_init_beta)
        alpha = float(config.adapter.tip_adapter_init_alpha)
        if beta == 0.0 or alpha == 0.0:
            # reference defect (quirk, COMPONENTS.md): the init values default
            # to 0.0 and no shipped config overrides them; alpha = 0 removes
            # the cache term from the loss, the adapter's gradient is
            # identically zero, and AdamW with the (also default) eps = 0
            # gives 0/0 = NaN on the first step. Train at the search grid's
            # first values instead; the (β, α) search after training is
            # unaffected.
            print("[Tip-Adapter-F] init beta/alpha of 0 give the adapter no "
                  "gradient (and NaN under eps=0); training at 1.0/1.0")
            beta = beta or 1.0
            alpha = alpha or 1.0
        n_batches = max(1, len(self.train_loader_x))
        # torch.optim.AdamW's default weight decay, 1e-2 (the reference passes
        # none, ref: tip_adapter.py:233); eps passes through verbatim, an
        # explicit 0.0 included (ref: tip_adapter.py:232-233)
        opt = StepAdamW([adapter_w], cosine_decay(lr, max(1, epochs * n_batches)),
                        weight_decay=1e-2, eps=float(config.adapter.tip_adapter_eps))
        test_labels_d = torch.from_numpy(test_labels.astype(np.int64)).to(self.device)
        # the GP classifier's test logits are sample-averaged once, as in the
        # JAX package; the final eval in train() draws its own samples
        with torch.no_grad():
            test_clip_logits = self._clip_logits(test_feats)
        # the best state is kept on the device: no host sync per epoch
        best_acc = torch.zeros((), device=self.device)
        best_w = adapter_w.detach().clone()
        for epoch in range(epochs):
            losses = AverageMeter()
            correct = torch.zeros((), device=self.device)
            total = 0
            for batch in self.train_loader_x:
                feats = self._encode_norm(batch["img"])
                labels = torch.from_numpy(batch["label"].astype(np.int64)).to(self.device)
                with torch.no_grad():
                    clip_logits = self._clip_logits(feats)
                opt.zero_grad()
                tip = clip_logits + alpha * cache_logits(
                    feats @ adapter_w.T, self.cache_vals, beta)
                loss = common.cross_entropy(tip, labels)
                loss.backward()
                opt.step()
                losses.update(loss.detach())
                correct += (tip.argmax(dim=1) == labels).sum()
                total += int(labels.shape[0])
            if epoch == 0 or (epoch + 1) % 10 == 0:
                print(f"epoch [{epoch + 1}/{epochs}] loss {float(losses.avg):.4f} "
                      f"acc_train {100.0 * float(correct) / max(1, total):.4f}")
            with torch.no_grad():
                tip = test_clip_logits + alpha * cache_logits(
                    test_feats @ adapter_w.T, self.cache_vals, beta)
                # never keep a numerically poisoned state: argmax over NaN
                # rows degenerates to class 0, which can beat an accuracy of 0
                acc = 100.0 * (tip.argmax(dim=1) == test_labels_d).float().mean()
                better = torch.isfinite(tip).all() & (acc > best_acc)
                best_acc = torch.where(better, acc, best_acc)
                best_w = torch.where(better, adapter_w, best_w)
        return best_w.clone()

    # metrics.json is written inside train(); the standard test() path is unused
    def predict_logits(self, features):
        with torch.no_grad():
            return self._tip_logits(
                features,
                getattr(self, "best_beta", float(self.config.adapter.tip_adapter_init_beta)),
                getattr(self, "best_alpha", float(self.config.adapter.tip_adapter_init_alpha)),
                getattr(self, "adapter_w", None),
            )
