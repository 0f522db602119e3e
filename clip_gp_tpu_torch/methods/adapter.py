"""The Adapter method — baseline and GP-weighted variants (the flagship).

Reference behavior (ref: trainers/adapter.py), as the JAX package's
``methods/adapter.py`` implements it: a frozen CLIP backbone with
per-class·template text embeddings [K,M,D], an identity-initialized
bias-free visual projection W [D,D], and one template-weighting head:
  - GP weighter (``use_gp``): variational GP samples template weights;
  - trainable per-class weight logits (``train_template_weights``);
  - linear weighting head (``use_linear_template_weighting``);
  - else the uniform template mean.

Training is feature-cached: the image tower runs once per split, then every
epoch iterates the cached features on the device. Loss = MC-averaged CE over
S prototype samples + β·KL + (λ/shots)‖W−I‖² (ref: compute_loss:387-535).
Eval MC-averages logits over ``gp_num_mc_samples_eval`` samples. Each step is
eager PyTorch with autograd; GP noise comes from per-batch generators of the
run's ``KeySequence``.

Checkpoints reload (``load_trainable_state``) in every mode; a reload on a
subset of the trained classes selects their rows of the per-class state and
of the GP buffers saved beside the checkpoints (``remap_trainable_state``).

With ``PREFIT_ON_FULL_SET`` the template weights are scored on the full
train split (``common.prefit_full_set_features``). A reference-format
checkpoint is adopted with its own GP basis (``adopt_reference_state``), and
``FINETUNE_ON_TEST`` runs the reference's sanity loop on the test features
after training (``_finetune_on_test``). With TensorBoard on, every step
writes ``train/loss`` and ``train/lr``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from clip_gp_tpu_torch.core.registry import TRAINER_REGISTRY
from clip_gp_tpu_torch.core.seeding import KeySequence
from clip_gp_tpu_torch.data.templates import get_templates
from clip_gp_tpu_torch.gp import svgp
from clip_gp_tpu_torch.methods import common
from clip_gp_tpu_torch.ops.metrics import AverageMeter, compute_accuracy
from clip_gp_tpu_torch.runtime.optim import MultiGroupOptimizer
from clip_gp_tpu_torch.runtime.profiling import maybe_trace, phase_timer
from clip_gp_tpu_torch.runtime.trainer_base import BaseTrainer


@TRAINER_REGISTRY.register("Adapter")
class Trainer(BaseTrainer):
    def __init__(self, config, dataset_manager, device=None):
        if getattr(config.dataset, "full_finetune", False):
            config.dataset.num_shots = 0
        super().__init__(config, dataset_manager, device)
        self.use_gp = bool(config.adapter.use_gp)
        self.s_train = max(1, int(config.adapter.gp_num_mc_samples_train or 1))
        self.s_eval = max(1, int(config.adapter.gp_num_mc_samples_eval or 1))
        # diagnostics-only stream: verbose accuracy draws must not advance the
        # training/eval stream (print cadence would otherwise change results)
        self._diag_keys = KeySequence(int(config.seed) + 7919, self.device)

    # ------------------------------------------------------------------
    def build_model(self):
        config = self.config
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {config.model.backbone_name})")
        _, model = self.load_clip_model()
        print("Building custom CLIP")
        self.templates = get_templates(config)
        self.text_embeddings = common.encode_templates(
            model, classnames, self.templates
        )  # [K,M,D]
        self.logit_scale = float(np.exp(model.logit_scale.item()))
        k, m, d = self.text_embeddings.shape
        dev = self.device

        self.params: Dict = {"visual_proj": torch.eye(d, device=dev)}
        self.gp_static = None
        self.gp_buffers = None
        self.mode = "uniform"
        train_tw = bool(config.adapter.train_template_weights)
        use_linear = bool(config.adapter.use_linear_template_weighting)
        if self.use_gp:
            self.mode = "gp"
            self.gp_static, gp_params, self.gp_buffers = svgp.create_gp(
                self.text_embeddings, config, dev
            )
            self.params["gp"] = gp_params
        elif train_tw and not use_linear:
            self.mode = "logits"
            # always per-class [K,M]: shared_template_weights shares only the
            # initialization (ref: adapter.py:174-176, 624-634)
            self.params["template_logits"] = torch.zeros(k, m, device=dev)
        elif use_linear:
            self.mode = "linear"
            self.params["template_weight_linear"] = 0.01 * torch.randn(
                d, 1, generator=self.keys.next(), device=dev
            )
        self._build_optimizer()

    def _leaves(self, name):
        sub = self.params[name]
        return list(sub.values()) if isinstance(sub, dict) else [sub]

    def _build_optimizer(self):
        config = self.config
        freeze_proj = bool(config.adapter.freeze_visual_proj)
        groups = {"base": [], "gp": []}
        for name in self.params:
            if name == "visual_proj" and freeze_proj:
                continue  # frozen: no grad, no update
            group = "gp" if name == "gp" else "base"
            for leaf in self._leaves(name):
                leaf.requires_grad_(True)
                groups[group].append(leaf)
        self._base_params = groups["base"]
        self._gp_params = groups["gp"]
        group_lrs = {"base": float(config.optim.lr)}
        if self.use_gp:
            group_lrs["gp"] = float(config.adapter.gp_lr)
        self.opt = MultiGroupOptimizer(config.optim, group_lrs, groups)

    # ------------------------------------------------------------------
    def _prototypes(self, generator, num_samples: int):
        """([S,K,D] (GP) or [K,D] prototypes, template weights or None)."""
        if self.mode == "gp":
            return svgp.sample_prototypes(
                self.gp_static, self.params["gp"], self.gp_buffers,
                num_samples, generator=generator,
            )
        e = self.text_embeddings
        if self.mode == "logits":
            logits = self.params["template_logits"]
            if logits.shape[0] == 1 and e.shape[0] > 1:
                logits = logits.expand(e.shape[:2])
            w = torch.softmax(logits, dim=-1)
            return torch.einsum("km,kmd->kd", w, e), w
        if self.mode == "linear":
            logits = (e @ self.params["template_weight_linear"])[..., 0]
            w = torch.softmax(logits, dim=-1)
            return torch.einsum("km,kmd->kd", w, e), w
        return e.mean(dim=1), None

    def _loss(self, features, labels, generator, l2_reg: bool = True):
        """MC cross-entropy + β·KL (GP) + the visual projection's L2 pull to
        the identity (``l2_reg``; the finetune-on-test loop has none)."""
        config = self.config
        shots = int(config.dataset.num_shots)
        projected = features @ self.params["visual_proj"].T
        f_norm = common.l2_normalize(projected)
        protos, _ = self._prototypes(generator, self.s_train)
        if protos.dim() == 3:
            ce = common.mc_cross_entropy(f_norm, protos, labels, self.logit_scale)
        else:
            ce = common.cross_entropy(
                common.cosine_logits(projected, protos, self.logit_scale), labels
            )
        total = ce
        zero = torch.zeros((), device=features.device)
        kl = zero
        if self.mode == "gp":
            kl = svgp.kl_divergence(self.params["gp"]).sum()
            total = total + float(config.adapter.gp_beta) * kl
        l2 = zero
        if l2_reg and not bool(config.adapter.freeze_visual_proj) and shots > 0:
            w = self.params["visual_proj"]
            eye = torch.eye(w.shape[0], device=w.device)
            l2 = ((w - eye) ** 2).sum() * (float(config.adapter.l2_lambda) / shots)
            total = total + l2
        return total, {"ce": ce, "kl": kl, "l2_reg": l2}

    def _train_step(self, features, labels, generator):
        self.opt.zero_grad()
        loss, aux = self._loss(features, labels, generator)
        loss.backward()

        def norm(params):
            sq = [p.grad.pow(2).sum() for p in params if p.grad is not None]
            return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())

        # "base" = every non-GP trainable, matching the reference's two
        # optimizer param groups (ref: trainers/adapter.py:298-311)
        gnorms = {"base": norm(self._base_params), "gp": norm(self._gp_params)}
        self.opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, gnorms

    def _eval_logits(self, features, generator, num_samples=None):
        with torch.no_grad():
            projected = features @ self.params["visual_proj"].T
            protos, _ = self._prototypes(generator, num_samples or self.s_eval)
            return common.cosine_logits(projected, protos, self.logit_scale)

    # ------------------------------------------------------------------
    def predict_logits(self, features):
        return self._eval_logits(features, self.keys.next())

    def _test_features_dev(self):
        if getattr(self, "_features_test_dev", None) is None:
            self._features_test_dev = torch.from_numpy(self.features_test).to(self.device)
        return self._features_test_dev

    def eval_logits_labels(self, split: str = "test"):
        if split == "test" and hasattr(self, "features_test"):
            logits = self.predict_logits(self._test_features_dev()).cpu().numpy()
            return logits, self.labels_test
        return super().eval_logits_labels(split)

    def trainable_state(self):
        return self.params

    def load_trainable_state(self, state):
        """Adopt a checkpoint's state (it may change K) and start a fresh
        optimizer over it, as the JAX package keeps its initial optimizer
        state when it swaps the params in."""
        self.params = self._adopt_state(state)
        self._build_optimizer()

    def adopt_reference_state(self, state, extra):
        """A converted reference checkpoint (``runtime/ref_checkpoint.py``):
        its GP state lives in the checkpoint's own PCA basis (torch SVD, with
        other column signs than numpy's), so its buffers replace the ones
        ``build_model`` derived, once the shapes and the mode match."""
        has_gp = "gp" in state
        if has_gp != (self.mode == "gp"):
            raise ValueError(
                "reference checkpoint "
                + ("carries" if has_gp else "lacks")
                + " GP state but this config has USE_GP "
                + ("disabled" if has_gp else "enabled")
                + "; pass the run's own config"
            )
        for name, present in (("template_logits", self.mode == "logits"),
                              ("template_weight_linear", self.mode == "linear")):
            if (name in state) != present:
                raise ValueError(
                    "reference checkpoint template-weight mode does not match "
                    f"this config (mode={self.mode!r}, checkpoint "
                    f"keys={sorted(state)})"
                )
        bufs = extra.get("gp_buffers")
        if bufs is not None:
            k_ck, m_ck, _ = np.shape(bufs["templates"])
            d_ck = int(np.shape(bufs["templates_red"])[-1])
            st = self.gp_static
            if (k_ck, m_ck, d_ck) != (st.num_classes, st.num_templates, st.red_dim):
                raise ValueError(
                    f"reference GP checkpoint shape (K={k_ck}, M={m_ck}, "
                    f"d={d_ck}) does not match this config (K={st.num_classes}, "
                    f"M={st.num_templates}, d={st.red_dim})"
                )
            kernel_key_sets = {
                "rbf": {"raw_lengthscale", "raw_outputscale"},
                "matern": {"raw_lengthscale"},
                "linear": {"raw_variance"},
            }
            # the key sets must be equal: an rbf checkpoint's keys include
            # matern's, and a missing-key check alone would evaluate rbf
            # parameters under the Matern kernel
            present = set(state["gp"]) & set().union(*kernel_key_sets.values())
            if present != kernel_key_sets[st.kernel_type]:
                raise ValueError(
                    "reference GP checkpoint kernel does not match this "
                    f"config's {st.kernel_type!r} kernel (checkpoint kernel "
                    f"params {sorted(present)}, expected "
                    f"{sorted(kernel_key_sets[st.kernel_type])})"
                )
            self.gp_buffers = self._adopt_state(bufs)
        return state

    def extra_checkpoint_state(self):
        # GP buffers (PCA basis + reduced templates) derive from the TRAINING
        # dataset's text; a class-subset reload must reuse them
        if self.mode == "gp":
            return {"gp_buffers": self.gp_buffers}
        return {}

    # per-class GP param leaves (leading dim K); tmp_bias [1,M] and A [d,d]
    # are class-agnostic
    _GP_PER_CLASS = (
        "inducing_token", "variational_mean", "chol_variational_covar",
        "cls_bias", "raw_lengthscale", "raw_outputscale", "raw_variance",
    )
    # "inducing_frozen" is read from JAX checkpoints written before that
    # buffer was folded into templates_red
    _GP_BUF_PER_CLASS = ("templates", "templates_red", "inducing_frozen", "f0")

    def remap_trainable_state(self, state, extra, idx):
        def take(a):
            return np.asarray(a)[idx]

        out = dict(state)
        if "template_logits" in out and np.asarray(out["template_logits"]).shape[0] > 1:
            out["template_logits"] = take(out["template_logits"])
        if "gp" in out:
            gp = dict(out["gp"])
            for name in self._GP_PER_CLASS:
                if name in gp:
                    gp[name] = take(gp[name])
            out["gp"] = gp
            bufs = extra.get("gp_buffers")
            if bufs is None:
                raise ValueError(
                    "GP checkpoint predates gp_buffers saving; cannot remap "
                    "across datasets — re-train or evaluate on the full "
                    "class set"
                )
            newb = {k: take(v) if k in self._GP_BUF_PER_CLASS else np.asarray(v)
                    for k, v in bufs.items()}
            if int(newb["f0"].shape[1]) != self.gp_static.num_templates:
                raise ValueError(
                    f"checkpoint template count {int(newb['f0'].shape[1])} != "
                    f"configured {self.gp_static.num_templates}"
                )
            self.gp_buffers = self._adopt_state(newb)
            self.gp_static = self.gp_static._replace(num_classes=len(idx))
        return out

    # ------------------------------------------------------------------
    def train(self):
        start_time = time.time()
        self.build_model()

        # zero-shot block on pre-extracted test features
        self.labels_test, zs_logits, self.features_test = self.extract_features(
            "test"
        )
        self._features_test_dev = None
        self.compute_zero_shot_block(zs_logits, self.labels_test)

        self.labels_train, _, self.features_train = self.extract_features("train")

        # score template weights on the full train split when configured
        # (ref: trainers/adapter.py:71-100)
        prefit = common.prefit_full_set_features(self.config, self)
        tw_feats, tw_labels = prefit or (self.features_train, self.labels_train)
        dev = self.device
        template_weights = common.get_template_weights(
            self.config,
            self.text_embeddings,
            torch.from_numpy(tw_feats).to(dev),
            torch.from_numpy(tw_labels).to(dev),
            self.logit_scale,
        )
        full_template_weights = template_weights
        if self.config.adapter.shared_template_weights:
            template_weights = template_weights.mean(dim=0, keepdim=True)

        with torch.no_grad():  # in place: the optimizer holds these tensors
            if self.mode == "logits":
                logits = self.params["template_logits"]
                logits.copy_(
                    torch.log(template_weights.clamp(min=1e-12)).expand_as(logits)
                )
            elif self.mode == "uniform":
                # the non-trainable baseline's forward ignores these (reference
                # executed behavior, ref: adapter.py:215-226, 636)
                self._baseline_template_weights = template_weights
            elif self.mode == "gp":
                # the GP warm start always gets per-class [K,M] weights
                warm = svgp.initialize_from_weights(
                    self.params["gp"], full_template_weights
                )
                self.params["gp"]["variational_mean"].copy_(warm["variational_mean"])
                print("[GP] One-step initialization applied to GP weights.")

        self.before_train()
        # the same trace and phase as BaseTrainer.train
        with maybe_trace("train", device=dev), phase_timer("train_epochs", device=dev):
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.before_epoch()
                self.run_epoch()
                self.after_epoch()

        if getattr(self.config.adapter, "finetune_on_test", False):
            self._finetune_on_test()

        self.after_train()
        self._print_weight_stats()
        print(f"Training completed in {time.time() - start_time:.2f} seconds")

    # ------------------------------------------------------------------
    def run_epoch(self):
        losses = AverageMeter()
        batch_time = AverageMeter()
        if not hasattr(self, "_features_train_dev"):
            self._features_train_dev = torch.from_numpy(self.features_train).to(self.device)
            self._labels_train_dev = torch.from_numpy(
                self.labels_train.astype(np.int64)
            ).to(self.device)
        # per-epoch shuffle: a host numpy draw, as the reference
        # (ref: trainers/adapter.py:732-735); the gather runs on the device
        idx = np.random.rand(self.features_train.shape[0]).argsort(axis=0)
        idx_dev = torch.from_numpy(idx).to(self.device)
        features = self._features_train_dev[idx_dev]
        labels_dev = self._labels_train_dev[idx_dev]
        labels_np = self.labels_train[idx]

        batch_size = self.config.dataloader.batch_size_train
        slices = common.batch_slices(self.features_train.shape[0], batch_size)
        self.num_batches = len(slices)
        print_freq = int(self.config.train.print_freq)
        verbose_epoch = (self.epoch + 1) % 10 == 0 or self.epoch == 0
        generators = self.keys.next(self.num_batches)
        if self.num_batches == 1:
            generators = [generators]

        end = time.time()
        for self.batch_idx, (lo, hi) in enumerate(slices):
            loss, aux, gnorms = self._train_step(
                features[lo:hi], labels_dev[lo:hi], generators[self.batch_idx]
            )
            losses.update(loss)
            batch_time.update(time.time() - end)

            meet_freq = (self.batch_idx + 1) % print_freq == 0
            few_batches = self.num_batches < print_freq
            if (meet_freq or few_batches) and verbose_epoch:
                loss = float(loss)
                acc_train = compute_accuracy(
                    self._eval_logits(
                        features[lo:hi], self._diag_keys.next(), self.s_train
                    ).cpu().numpy(),
                    labels_np[lo:hi],
                )[0]
                acc_test = compute_accuracy(
                    self._eval_logits(
                        self._test_features_dev(), self._diag_keys.next()
                    ).cpu().numpy(),
                    self.labels_test,
                )[0]
                nb_remain = (self.num_batches - self.batch_idx - 1) + (
                    self.max_epoch - self.epoch - 1
                ) * self.num_batches
                eta = int(batch_time.avg * nb_remain)
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}] "
                    f"batch [{self.batch_idx + 1}/{self.num_batches}] "
                    f"loss {loss:.4f} acc_train {acc_train:.4f} "
                    f"acc_test {acc_test:.4f} eta {eta}s"
                )
                print(
                    f"  [DBG] loss: CE={float(aux['ce']):.4f} "
                    f"KL={float(aux['kl']):.4f} l2_reg={float(aux['l2_reg']):.4f} "
                    f"Total={loss:.4f}"
                )
                print(
                    f"  [DBG] grad_norms: base={float(gnorms['base']):.6f} "
                    f"gp={float(gnorms['gp']):.6f}"
                )
                if self.mode == "gp":
                    self._print_gp_diagnostics()
            if self._writer is not None:  # TensorBoard accepts the per-step sync
                n_iter = self.epoch * self.num_batches + self.batch_idx
                self.write_scalar("train/loss", float(loss), n_iter)
                self.write_scalar("train/lr", self.opt.current_lrs.get("base", 0.0),
                                  n_iter)
            end = time.time()

        self.opt.set_epoch(self.epoch + 1)
        return {"loss": losses.avg}

    def _print_gp_diagnostics(self):
        gp = {k: v.detach() for k, v in self.params["gp"].items()}
        q_m = gp["variational_mean"].cpu().numpy()
        lq = np.tril(gp["chol_variational_covar"].cpu().numpy())
        q_var = np.einsum("kpq,krq->kpr", lq, lq).diagonal(axis1=-2, axis2=-1)
        parts = [
            f"q_m[min={q_m.min():.4f} max={q_m.max():.4f}]",
            f"q_var[min={q_var.min():.4f} max={q_var.max():.4f}]",
        ]
        if "raw_lengthscale" in gp:
            ls = float(np.mean(np.log1p(np.exp(gp["raw_lengthscale"].cpu().numpy()))))
            parts.append(f"lengthscale={ls:.6f}")
        if "raw_outputscale" in gp:
            os_ = float(np.mean(np.log1p(np.exp(gp["raw_outputscale"].cpu().numpy()))))
            parts.append(f"outputscale={os_:.6f}")
        print("  [DBG][GP] " + " ".join(parts))
        with torch.no_grad():
            w = svgp.posterior_mean_weights(self.gp_static, gp, self.gp_buffers)
        w0 = ", ".join(f"{v:.3f}" for v in w[0].cpu().numpy())
        print(f"  [DBG][GP] template_weights[class=0]: [{w0}]")

    def _print_weight_stats(self):
        with torch.no_grad():
            if self.mode == "gp":
                _, w = svgp.sample_prototypes(
                    self.gp_static, self.params["gp"], self.gp_buffers,
                    self.s_eval, generator=self.keys.next(),
                )
                w = w.cpu().numpy()
                mean_vals = w.mean(axis=0)[0]
                std_vals = w.std(axis=0)[0]
                print("Weights: mean = [{}]".format(
                    ", ".join(f"{v:.4f}" for v in mean_vals)))
                print("          std = [{}]".format(
                    ", ".join(f"{v:.4f}" for v in std_vals)))
            elif self.mode in ("logits", "linear"):
                _, w = self._prototypes(self.keys.next(), 1)
                mean_vals = w.cpu().numpy().mean(axis=0)
                print("Weights: mean = [{}]".format(
                    ", ".join(f"{v:.4f}" for v in mean_vals)))

    # ------------------------------------------------------------------
    def _finetune_on_test(self):
        """Sanity ceiling check: optimize only the weighting head on the test
        set (ref: trainers/adapter.py:968-1065), as the JAX package runs it.
        Not for regular training.

        Mini-batches of ``gp_test_batch_size`` (else the test batch size)
        over the test features shuffled once, the ragged tail kept; 100
        epochs with the configured lr schedule set per epoch; a test
        accuracy line per epoch. In 'uniform' mode the reference promotes
        the stored template-weights tensor to a trainable parameter that
        the forward then reads as logits (ref: adapter.py:978-981 and
        215-222): here the 'logits' head, initialized with the weight
        values (the softmax of a constant row is uniform, so the start is
        unchanged). The visual projection stays frozen."""
        if self.mode == "uniform":
            tw = getattr(self, "_baseline_template_weights", None)
            if tw is None:
                k, m = self.text_embeddings.shape[:2]
                tw = torch.full((k, m), 1.0 / max(m, 1), device=self.device)
            self.params["template_logits"] = tw.detach().clone().requires_grad_(True)
            self.mode = "logits"
        self.params["visual_proj"].requires_grad_(False)
        leaves = [leaf for name in self.params if name != "visual_proj"
                  for leaf in self._leaves(name)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        opt = MultiGroupOptimizer(self.config.optim, {"base": float(self.config.optim.lr)},
                                  {"base": leaves})
        n = int(self.features_test.shape[0])
        # one shuffle per run from the process-global numpy stream
        # (ref: adapter.py:1020-1022)
        idx = np.random.rand(n).argsort(axis=0)
        idx_dev = torch.from_numpy(idx).to(self.device)
        features_all = self._test_features_dev()[idx_dev]
        labels_np = self.labels_test[idx]
        labels_all = torch.from_numpy(labels_np.astype(np.int64)).to(self.device)
        default_bs = int(self.config.dataloader.batch_size_test)
        bs = max(1, int(getattr(self.config.adapter, "gp_test_batch_size", 0)
                        or default_bs))
        num_batches = int(np.ceil(n / float(bs)))
        num_epochs = 100
        print("[SANITY] Template weights fine-tuning on TEST set: "
              f"epochs={num_epochs} bs={bs} lr={float(self.config.optim.lr)}")
        for ep in range(num_epochs):
            opt.set_epoch(ep)
            running = torch.zeros((), device=self.device)
            for b in range(num_batches):
                b0, b1 = b * bs, min((b + 1) * bs, n)
                opt.zero_grad()
                loss, _ = self._loss(features_all[b0:b1], labels_all[b0:b1],
                                     self.keys.next(), l2_reg=False)
                loss.backward()
                opt.step()
                running = running + loss.detach() * (b1 - b0)
            logits = self._eval_logits(features_all, self.keys.next()).cpu().numpy()
            acc = compute_accuracy(logits, labels_np)[0]
            print(f"[SANITY] Template weights test fine-tune epoch "
                  f"{ep + 1}/{num_epochs}: loss={float(running) / n:.4f} "
                  f"acc_test={acc:.4f}")
