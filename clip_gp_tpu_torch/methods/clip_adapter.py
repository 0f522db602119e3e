"""CLIP-Adapter: a bottleneck MLP on the visual features, blended with the
original (ref: trainers/clip_adapter.py; JAX ``methods/clip_adapter.py``).

Adapter = Linear(D→D/r) → ReLU → Linear(D/r→D) → ReLU (bias-free), blended as
``ratio·adapted + (1−ratio)·orig``; the classifier is the zero-shot
clip_weights [D,K], optionally replaced by GP-mean prototypes or learned
template-weight prototypes from the shared pre-stages. The adapter trains
with CE under its own optimizer settings (clip_adapter_{optimizer,lr,epochs}),
and every step re-encodes its augmented few-shot images through the frozen
tower (augmentation is the point of re-encoding): on a ViT that is K1/K2 in
every block of every step. Test features are encoded once.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from clip_gp_tpu_torch.core.registry import TRAINER_REGISTRY
from clip_gp_tpu_torch.data.templates import get_templates
from clip_gp_tpu_torch.gp import svgp
from clip_gp_tpu_torch.methods import common, pre_stages
from clip_gp_tpu_torch.ops.metrics import AverageMeter, compute_accuracy
from clip_gp_tpu_torch.runtime.optim import EpochOptimizer, _OverrideLr
from clip_gp_tpu_torch.runtime.trainer_base import BaseTrainer


def init_adapter(d: int, hidden: int, generator=None,
                 uniforms: Optional[Dict] = None, device=None) -> Dict:
    """{fc1 [D, hidden], fc2 [hidden, D]} in right-multiply form, each drawn
    from U(±1/√fan_in) as torch's ``nn.Linear`` draws its weight. ``uniforms``
    (the same dict of U[0, 1) draws) replaces the ``generator``'s draws, so
    tests can feed the JAX package's."""
    params = {}
    for name, shape in (("fc1", (d, hidden)), ("fc2", (hidden, d))):
        bound = 1.0 / math.sqrt(shape[0])
        u = (torch.rand(shape, generator=generator, device=device)
             if uniforms is None else torch.as_tensor(uniforms[name], device=device))
        # the scaling of jax.random.uniform(minval=-bound, maxval=bound)
        params[name] = u.float() * (2 * bound) - bound
    return params


@TRAINER_REGISTRY.register("CLIP-Adapter")
class Trainer(BaseTrainer):
    def build_model(self):
        config = self.config
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {config.model.backbone_name})")
        _, model = self.load_clip_model()
        print("Building CLIP-Adapter")
        self.templates = get_templates(config)
        self.text_embeddings = common.encode_templates(model, classnames,
                                                       self.templates)
        self.clip_weights = common.zero_shot_classifier(self.text_embeddings)  # [D,K]
        self.logit_scale = float(np.exp(model.logit_scale.item()))
        d = int(self.text_embeddings.shape[-1])
        hidden = max(1, d // max(1, int(config.adapter.clip_adapter_reduction)))
        self.params = init_adapter(d, hidden, generator=self.keys.next(),
                                   device=self.device)
        self.ratio = float(config.adapter.clip_adapter_ratio)
        # GP runs use the classifier without renormalization; config-derived
        # so --eval-only reloads pick the right path too
        self._gp_classifier = bool(config.adapter.use_gp)
        self._build_optimizer()

    def _build_optimizer(self):
        # the adapter's own optimizer settings (ref: _TmpOptim shim,
        # trainers/clip_adapter.py:152-167)
        config = self.config
        opt_cfg = _OverrideLr(config.optim, float(config.adapter.clip_adapter_lr))
        opt_cfg.name = str(config.adapter.clip_adapter_optimizer)
        opt_cfg.max_epoch = int(config.adapter.clip_adapter_epochs)
        for p in self.params.values():
            p.requires_grad_(True)
        self.opt = EpochOptimizer(opt_cfg, list(self.params.values()))

    def _logits(self, feats: torch.Tensor) -> torch.Tensor:
        p = self.params
        adapted = torch.relu(torch.relu(feats @ p["fc1"]) @ p["fc2"])
        f = common.l2_normalize(self.ratio * adapted + (1.0 - self.ratio) * feats)
        w = self.clip_weights
        if not self._gp_classifier:
            w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True)
        # GP path: the classifier is the unnormalized mean over normalized MC
        # prototype samples: the logits are linear in the prototypes, so
        # scale·f@mean(p̂ₛ) equals the reference's mean-over-samples logits
        # (ref: clip_adapter.py:85-97), and the per-class ‖mean‖ < 1
        # shrinkage (the GP's uncertainty) must not be normalized away
        return self.logit_scale * f @ w

    def _encode(self, images_u8: np.ndarray) -> torch.Tensor:
        images = torch.from_numpy(images_u8).to(self.device)
        with torch.no_grad():
            return self.clip_model.encode_image(self.preprocess(images))

    # ------------------------------------------------------------------
    def predict_logits(self, features):
        with torch.no_grad():
            return self._logits(features)

    def eval_logits_labels(self, split: str = "test"):
        if split == "test" and hasattr(self, "features_test"):
            feats = torch.from_numpy(self.features_test).to(self.device)
            return self.predict_logits(feats).cpu().numpy(), self.labels_test
        return super().eval_logits_labels(split)

    def trainable_state(self):
        return {"adapter": self.params, "clip_weights": self.clip_weights}

    def load_trainable_state(self, state):
        state = self._adopt_state(state)
        self.params = state["adapter"]
        self.clip_weights = state["clip_weights"]
        self._build_optimizer()

    def remap_trainable_state(self, state, extra, idx):
        # the MLP adapter is class-agnostic; the classifier is [D, K]
        return {"adapter": state["adapter"],
                "clip_weights": np.asarray(state["clip_weights"])[:, idx]}

    # ------------------------------------------------------------------
    def train(self):
        start_time = time.time()
        self.build_model()
        config = self.config
        dev = self.device

        self.labels_test, self.features_test = self.encode_images_batched(
            self.test_loader, cacheable=True)
        zs_logits = self.predict_logits(
            torch.from_numpy(self.features_test).to(dev)).cpu().numpy()
        self.compute_zero_shot_block(zs_logits, self.labels_test)

        if bool(config.adapter.use_gp):
            tr_labels, tr_feats = self.encode_images_batched(self.train_loader_x)
            prefit = common.prefit_full_set_features(config, self)
            self.gp_bundle, _ = pre_stages.train_gp_stage(
                config,
                self.text_embeddings,
                common.l2_normalize(torch.from_numpy(tr_feats).to(dev)),
                tr_labels,
                self.keys,
                warm_start_scale=self.logit_scale,
                init_features=prefit[0] if prefit else None,
                init_labels=prefit[1] if prefit else None,
            )
            # the classifier: mean over S_eval normalized samples, left
            # unnormalized (the reference's per-forward MC-mean logits)
            static, gp_params, buffers = self.gp_bundle
            s_eval = max(1, int(config.adapter.gp_num_mc_samples_eval or 1))
            with torch.no_grad():
                protos, _ = svgp.sample_prototypes(
                    static, gp_params, buffers, s_eval, generator=self.keys.next())
                self.clip_weights = common.l2_normalize(protos).mean(dim=0).T
            print("[CLIP-Adapter] Using trained GP-based template weighter for "
                  "prototypes.")
        elif bool(config.adapter.clip_adapter_use_template_weight_training):
            tr_labels, tr_feats = self.encode_images_batched(self.train_loader_x)
            _, protos = pre_stages.train_template_weight_stage(
                config,
                self.text_embeddings,
                common.l2_normalize(torch.from_numpy(tr_feats).to(dev)),
                tr_labels,
                n_batches=max(1, len(self.train_loader_x)),
            )
            self.clip_weights = protos.T

        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
        self.after_train()
        print(f"Training completed in {time.time() - start_time:.2f} seconds")

    def run_epoch(self):
        losses = AverageMeter()
        loader = self.train_loader_x
        self.num_batches = len(loader)
        verbose = self.epoch == 0 or (self.epoch + 1) % 10 == 0
        for self.batch_idx, batch in enumerate(loader):
            feats = self._encode(batch["img"])
            labels = torch.from_numpy(batch["label"].astype(np.int64)).to(self.device)
            self.opt.zero_grad()
            logits = self._logits(feats)
            loss = common.cross_entropy(logits, labels)
            loss.backward()
            self.opt.step()
            loss = loss.detach()
            losses.update(loss)
            if verbose:
                acc_train = compute_accuracy(logits.detach().cpu().numpy(),
                                             batch["label"])[0]
                logits_test = self.eval_logits_labels("test")[0]
                acc_test = compute_accuracy(logits_test, self.labels_test)[0]
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                    f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                    f"loss {float(loss):.4f} acc_train {acc_train:.4f} "
                    f"acc_test {acc_test:.4f}"
                )
            if self._writer is not None:  # float(loss) waits for the device
                self.write_scalar("train/loss", float(loss),
                                  self.epoch * self.num_batches + self.batch_idx)
        self.opt.set_epoch(self.epoch + 1)
        return float(losses.avg)
