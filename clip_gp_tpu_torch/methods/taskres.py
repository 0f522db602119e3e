"""TaskRes: a learnable residual on frozen base text features
(ref: trainers/taskres.py; JAX ``methods/taskres.py``).

The base text features t [K,D] are the mean over the M template embeddings;
the only trainable state is the zero-initialized residual x, with
t' = t + α·x (``taskres_residual_scale``). Optional pre-stages replace the
base features with GP-mean prototypes or learned template-weight prototypes.
With the GP, every step draws S_train prototype samples and the residual is
added to each normalized sample (ref: taskres.py:96-116); evaluation draws
S_eval. Every step re-encodes its few-shot images through the frozen tower.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from clip_gp_tpu_torch.core.registry import TRAINER_REGISTRY
from clip_gp_tpu_torch.data.templates import get_templates
from clip_gp_tpu_torch.gp import svgp
from clip_gp_tpu_torch.methods import common, pre_stages
from clip_gp_tpu_torch.ops.metrics import AverageMeter, compute_accuracy
from clip_gp_tpu_torch.runtime.optim import EpochOptimizer, _OverrideLr
from clip_gp_tpu_torch.runtime.trainer_base import BaseTrainer


@TRAINER_REGISTRY.register("TaskRes")
class Trainer(BaseTrainer):
    def build_model(self):
        config = self.config
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {config.model.backbone_name})")
        _, model = self.load_clip_model()
        print("Building TaskRes adapter")
        self.templates = get_templates(config)
        self.text_embeddings = common.encode_templates(model, classnames,
                                                       self.templates)
        self.logit_scale = float(np.exp(model.logit_scale.item()))
        self.alpha = float(config.adapter.taskres_residual_scale)
        print(f">> TaskRes scale factor: {self.alpha}")
        # base text features: the plain mean over templates (ref: taskres.py:72-94)
        self.base_text_features = self.text_embeddings.mean(dim=1)  # [K,D]
        self.params = {"residuals": torch.zeros_like(self.base_text_features)}
        self.gp_bundle = None
        self.s_train = max(1, int(config.adapter.gp_num_mc_samples_train or 1))
        self.s_eval = max(1, int(config.adapter.gp_num_mc_samples_eval or 1))
        self._build_optimizer()

    def _build_optimizer(self):
        config = self.config
        opt_cfg = _OverrideLr(config.optim, float(config.adapter.taskres_lr))
        opt_cfg.name = str(config.adapter.taskres_optimizer)
        opt_cfg.max_epoch = int(config.adapter.taskres_epochs)
        self.params["residuals"].requires_grad_(True)
        self.opt = EpochOptimizer(opt_cfg, [self.params["residuals"]])

    def _gp_path(self) -> bool:
        return self.gp_bundle is not None and bool(self.config.adapter.use_gp)

    def _logits(self, feats, num_samples: int):
        """Cosine logits against t + α·x, or on the GP path against each of
        ``num_samples`` normalized prototype samples plus α·x (drawn from the
        next generator of the run's stream), averaged over the samples."""
        residuals = self.alpha * self.params["residuals"]
        if not self._gp_path():
            return common.cosine_logits(feats, self.base_text_features + residuals,
                                        self.logit_scale)
        static, gp_params, buffers = self.gp_bundle
        with torch.no_grad():
            protos, _ = svgp.sample_prototypes(static, gp_params, buffers,
                                               num_samples,
                                               generator=self.keys.next())
        text_s = common.l2_normalize(protos) + residuals[None]
        return common.cosine_logits(feats, text_s, self.logit_scale)

    def _encode(self, images_u8: np.ndarray) -> torch.Tensor:
        images = torch.from_numpy(images_u8).to(self.device)
        with torch.no_grad():
            return self.clip_model.encode_image(self.preprocess(images))

    # ------------------------------------------------------------------
    def predict_logits(self, features):
        with torch.no_grad():
            return self._logits(features, self.s_eval)

    def eval_logits_labels(self, split: str = "test"):
        if split == "test" and hasattr(self, "features_test"):
            feats = torch.from_numpy(self.features_test).to(self.device)
            return self.predict_logits(feats).cpu().numpy(), self.labels_test
        return super().eval_logits_labels(split)

    def trainable_state(self):
        return {"residuals": self.params["residuals"],
                "base_text_features": self.base_text_features}

    def load_trainable_state(self, state):
        state = self._adopt_state(state)
        self.params = {"residuals": state["residuals"]}
        self.base_text_features = state["base_text_features"]
        self._build_optimizer()

    def remap_trainable_state(self, state, extra, idx):
        # residuals and base text features are both [K, D]
        return {"residuals": np.asarray(state["residuals"])[idx],
                "base_text_features": np.asarray(state["base_text_features"])[idx]}

    # ------------------------------------------------------------------
    def train(self):
        start_time = time.time()
        self.build_model()
        config = self.config
        dev = self.device

        self.labels_test, self.features_test = self.encode_images_batched(
            self.test_loader, cacheable=True)
        # the zero-shot baseline with the standard zero-shot classifier
        zs_w = common.zero_shot_classifier(self.text_embeddings)
        with torch.no_grad():
            feats_test = torch.from_numpy(self.features_test).to(dev)
            zs_logits = (100.0 * common.l2_normalize(feats_test) @ zs_w).cpu().numpy()
        self.compute_zero_shot_block(zs_logits, self.labels_test)

        if bool(config.adapter.use_gp):
            tr_labels, tr_feats = self.encode_images_batched(self.train_loader_x)
            # the reference's GP branch builds E with per-template L2
            # normalization (ref: taskres.py:234), unlike CLIP-Adapter's raw E
            # and unlike TaskRes's own TW branch below (ref: taskres.py:317)
            prefit = common.prefit_full_set_features(config, self)
            self.gp_bundle, self.base_text_features = pre_stages.train_gp_stage(
                config,
                common.l2_normalize(self.text_embeddings),
                common.l2_normalize(torch.from_numpy(tr_feats).to(dev)),
                tr_labels,
                self.keys,
                warm_start_scale=self.logit_scale,
                init_features=prefit[0] if prefit else None,
                init_labels=prefit[1] if prefit else None,
            )
            print("[TaskRes] Using trained GP-based template weighter for "
                  "prototypes.")
        elif bool(config.adapter.taskres_use_template_weight_training):
            tr_labels, tr_feats = self.encode_images_batched(self.train_loader_x)
            _, self.base_text_features = pre_stages.train_template_weight_stage(
                config,
                self.text_embeddings,
                common.l2_normalize(torch.from_numpy(tr_feats).to(dev)),
                tr_labels,
                l2_to_uniform_lambda=float(config.adapter.template_tw_l2_lambda),
                n_batches=max(1, len(self.train_loader_x)),
            )

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
            # the GP path trains through S_train fresh prototype samples per
            # step: normalize(p̂ₛ + α·x) is nonlinear in the samples
            logits = self._logits(feats, self.s_train)
            loss = common.cross_entropy(logits, labels)
            loss.backward()
            self.opt.step()
            loss = loss.detach()
            losses.update(loss)
            if verbose:
                acc_train = compute_accuracy(logits.detach().cpu().numpy(),
                                             batch["label"])[0]
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                    f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                    f"loss {float(loss):.4f} acc_train {acc_train:.4f}"
                )
            if self._writer is not None:  # float(loss) waits for the device
                self.write_scalar("train/loss", float(loss),
                                  self.epoch * self.num_batches + self.batch_idx)
        self.opt.set_epoch(self.epoch + 1)
        return float(losses.avg)
