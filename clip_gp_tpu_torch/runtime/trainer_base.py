"""Trainer lifecycle runtime: feature extraction, evaluation, checkpoints,
metrics.json.

The same contract as the JAX package's ``runtime/trainer_base.py`` (itself in
parity with the reference BaseTrainer, ref: utils/trainer.py:240-663): the
lifecycle hooks (train → before_train → [epoch loop] → after_train → test),
the ``metrics.json`` schema, the ``<out>/adapter/`` checkpoint directory,
and ``max_epoch`` taken from ``adapter.clip_adapter_epochs`` for every
trainer (ref quirk SURVEY §2.3.3). The frozen CLIP runs on ``self.device``
(the GPU unless the caller asks for the CPU, see ``core/device.py``).

Checkpoints reload as the JAX package's do: ``load_model`` finds the npz
(an explicit epoch, else ``model-best``, else the highest epoch), remaps
per-class state to the evaluated classes (by class key, else by unique class
name), and serves ``--resume``, ``--eval-only``, ``FINAL_MODEL best_val`` and
the predict entry. With ``MODEL.INT8_INFERENCE`` the image encodes run the
int8 ViT tower (``models/quantized.py``, K5/K6), its weights quantized once
per loaded tower. Where a run directory holds no npz but a reference-format
checkpoint (``model.pth.tar-*``), ``load_model`` converts it
(``runtime/ref_checkpoint.py``) and the trainer adopts it
(``adopt_reference_state``).

The val and test extractions go through the feature cache
(``runtime/feature_cache.py``: an in-process memo, and a disk cache under
``CLIP_GP_TPU_TORCH_FEATURE_CACHE``); the train split never does. Each
extraction is timed as the ``feature_extraction`` phase and the epoch loop
as ``train_epochs`` (``runtime/profiling.py``), under a ``torch.profiler``
trace when ``CLIP_GP_TPU_TORCH_PROFILE_DIR`` is set. With
``TRAIN.ENABLE_TENSORBOARD`` the scalars go to ``<output_dir>/tensorboard``
through tensorboardX, or, without tensorboardX, nowhere (the JAX package's
behavior: a printed line, and no result changes). Sharded extraction
belongs to the trial-batched sweep and is not here.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from clip_gp_tpu_torch.core.device import resolve_device
from clip_gp_tpu_torch.core.seeding import KeySequence
from clip_gp_tpu_torch.data.transforms import preprocess_fn
from clip_gp_tpu_torch.models import quantized
from clip_gp_tpu_torch.models.clip_loader import load_clip_resolved
from clip_gp_tpu_torch.ops.metrics import (
    compute_accuracy,
    compute_aece,
    compute_aece_with_bins,
    compute_ece,
    compute_ece_with_bins,
    compute_macro_f1,
)
from clip_gp_tpu_torch.runtime import feature_cache
from clip_gp_tpu_torch.runtime.checkpoint import _flatten, _unflatten, find_run_checkpoint
from clip_gp_tpu_torch.runtime.profiling import maybe_trace, phase_timer

CKPT_PREFIX = "model.ckpt-"


def resolve_checkpoint_path(model_dir: str, epoch: Optional[int] = None):
    """<out>/adapter checkpoint discovery: explicit epoch, else model-best,
    else highest-numbered (ref: utils/trainer.py:376-399). None if absent."""
    return find_run_checkpoint(model_dir, epoch, CKPT_PREFIX, ".npz", "model-best.npz")


def read_checkpoint_classnames(path) -> Optional[list]:
    """Label-ordered classnames stored in a checkpoint, if present."""
    with np.load(path, allow_pickle=False) as data:
        if "__classnames__" in data.files:
            return [str(c) for c in data["__classnames__"]]
    return None


def infer_method_name(config) -> str:
    """Method tag for metrics.json (ref: utils/trainer.py:604-619), with the
    JAX package's mapping of the canonical trainer spellings."""
    tname = getattr(config, "trainer_name", "")
    mapping = {
        "Adapter-TipA-F": "tipaf",
        "Tip-Adapter-F": "tipaf",
        "Adapter-TipA": "tipa",
        "Tip-Adapter": "tipaf" if config.adapter.tip_adapter_trainable else "tipa",
        "Adapter-CoOp": "coop",
        "Adapter-CoCoOp": "cocoop",
        "Adapter-CLIP-Adapter": "clip-adapter",
        "CLIP-Adapter": "clip-adapter",
        "TaskRes": "taskres",
    }
    if tname in mapping:
        return mapping[tname]
    return "gp" if bool(getattr(config.adapter, "use_gp", False)) else "baseline"


class BaseTrainer:
    def __init__(self, config, dataset_manager, device=None):
        self.config = config
        self.dm = dataset_manager
        self.device = resolve_device(device)
        self.start_epoch = self.epoch = 0
        # parity quirk: every trainer's epoch budget comes from
        # adapter.clip_adapter_epochs (ref: utils/trainer.py:256)
        self.max_epoch = int(config.adapter.clip_adapter_epochs)
        self.output_dir = config.output_dir
        self.train_loader_x = dataset_manager.train_loader_x
        self.val_loader = dataset_manager.val_loader
        self.test_loader = dataset_manager.test_loader
        self.num_classes = dataset_manager.num_classes
        self.lab2cname = dataset_manager.lab2cname
        self.time_start: Optional[float] = None
        self.keys = KeySequence(int(config.seed), self.device)
        self.preprocess = preprocess_fn(config)
        self.zero_shot_metrics: Optional[Dict] = None
        self._best_val_acc = float("-inf")
        self._val_feature_memo: Optional[Tuple] = None
        # the TensorBoard writer, opened by before_train
        self._writer = None
        # set by build_model
        self.clip_arch = None
        self.clip_model = None
        self._encode_plan_cached: Optional[Dict] = None

    # ------------------------------------------------------------------
    # model plumbing provided by subclasses
    # ------------------------------------------------------------------
    def build_model(self):
        raise NotImplementedError

    def predict_logits(self, features: torch.Tensor) -> torch.Tensor:
        """Eval-mode logits from CLIP visual features [N,D] → [N,K]."""
        raise NotImplementedError

    def trainable_state(self) -> Dict:
        """Small trainable state (nested dict of tensors) for checkpoints."""
        return {}

    def load_trainable_state(self, state: Dict) -> None:
        pass

    def _adopt_state(self, state):
        """A checkpoint state (nested dicts of numpy arrays or tensors) as
        fresh fp32 tensors on ``self.device``."""
        if isinstance(state, dict):
            return {k: self._adopt_state(v) for k, v in state.items()}
        if isinstance(state, torch.Tensor):
            state = state.detach().cpu().numpy()
        return torch.tensor(np.asarray(state), dtype=torch.float32,
                            device=self.device)

    # ------------------------------------------------------------------
    # CLIP + feature extraction
    # ------------------------------------------------------------------
    def load_clip_model(self):
        allow_random = os.environ.get("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS") == "1"
        self.clip_arch, self.clip_model, self.weights_tag = load_clip_resolved(
            self.config, allow_random=allow_random, seed=int(self.config.seed),
            device=self.device,
        )
        # the encode plan (and its quantized tower) belongs to the weights
        # just replaced
        self._encode_plan_cached = None
        if (getattr(self.config.model, "int8_inference", False)
                and not self.clip_arch.is_vit):
            # at load time, as the JAX package warns: the int8 tower covers
            # the ViT towers only, and the frozen encode runs in fp32
            print("[WARN] MODEL.INT8_INFERENCE covers the ViT towers only; "
                  f"falling back to fp32 for {self.clip_arch.name}")
        return self.clip_arch, self.clip_model

    def _int8_effective(self) -> bool:
        """Whether extraction runs the int8 tower: the config flag and a
        tower the int8 path covers (ViT only)."""
        return bool(
            getattr(self.config.model, "int8_inference", False)
            and self.clip_arch is not None
            and self.clip_arch.is_vit
        )

    def _encode_plan(self) -> Dict:
        """Extraction decisions, frozen once per loaded tower: int8 or not,
        the int8 tower's weights, quantized once, and the devices the batch
        splits over (``parallel/mesh.extraction_shard_devices``). The
        feature-cache key and the encode read this one snapshot, so a key
        always describes the encode that ran. A weight reload drops the
        plan, and with it the quantized tower and the replicas."""
        if self._encode_plan_cached is None:
            from clip_gp_tpu_torch.parallel.mesh import extraction_shard_devices

            int8 = self._int8_effective()
            devices = extraction_shard_devices()
            self._encode_plan_cached = {
                "int8": int8,
                "qvisual": (quantized.quantize_visual(self.clip_model, self.clip_arch)
                            if int8 else None),
                "shard_device_list": devices,
                "shard_devices": len(devices) if devices else 0,
                "sharded": None,
            }
        return self._encode_plan_cached

    def encode_images_batched(self, loader, cacheable: bool = False
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """One pass of the frozen image tower over a loader → (labels [N],
        features [N,D]): the fp32 tower, or with ``MODEL.INT8_INFERENCE`` the
        int8 tower in bf16 (every block K5 then K6). The training math is the
        same either way: every method trains on the extracted features.

        ``cacheable=True`` (the deterministic val and test splits only)
        consults the feature cache first: a hit runs no tower."""
        if not cacheable:
            return self._encode_batched_uncached(loader, None)
        key = feature_cache.cache_key(
            self.config, loader.data_source, getattr(self, "weights_tag", "default"),
            device_type=self.device.type, int8=self._encode_plan()["int8"],
            shard_devices=self._encode_plan()["shard_devices"],
        )
        # a second trainer missing the memo for a split that another thread
        # is encoding waits for that encode
        with feature_cache.inflight_lock(key):
            hit = feature_cache.memo_get(key)
            if hit is not None:
                print(f"[feature-cache] memo hit: {key}")
                return hit
            hit = feature_cache.load(key)
            if hit is not None:
                print(f"[feature-cache] hit: {key}")
                feature_cache.memo_put(key, *hit)
                return hit
            return self._encode_batched_uncached(loader, key)

    def _encode_batched_uncached(self, loader, key: Optional[str]
                                 ) -> Tuple[np.ndarray, np.ndarray]:
        # imported here: importing the methods package registers the trainers,
        # which import this module
        from clip_gp_tpu_torch.methods.common import extract_with

        plan = self._encode_plan()

        def encode(images_u8: np.ndarray) -> torch.Tensor:
            images = torch.from_numpy(images_u8).to(self.device)
            with torch.no_grad():
                x = self.preprocess(images)
                if plan["int8"]:
                    return quantized.encode_image_q8(plan["qvisual"],
                                                     self.clip_arch, x)
                return self.clip_model.encode_image(x)

        if plan["shard_devices"] > 1:
            # the batch splits over the plan's devices, each chunk on that
            # device's replica of the image tower (the quantized tree, or
            # the visual module as CLIP.encode_image runs it), made once
            # per plan
            if plan["sharded"] is None:
                from clip_gp_tpu_torch.parallel.mesh import maybe_sharded_encode

                arch, preprocess = self.clip_arch, self.preprocess

                def encode_on(tower, images: torch.Tensor) -> torch.Tensor:
                    with torch.no_grad():
                        x = preprocess(images)
                        if plan["int8"]:
                            return quantized.encode_image_q8(tower, arch, x)
                        return tower(x.to(torch.float32)).float()

                plan["sharded"] = maybe_sharded_encode(
                    encode_on, plan["qvisual"] if plan["int8"] else self.clip_model.visual,
                    devices=plan["shard_device_list"])
            encode = plan["sharded"]

        with phase_timer("feature_extraction", device=self.device):
            feats, labels = extract_with(encode, loader)
        if key is not None:
            feature_cache.memo_put(key, labels, feats)
            feature_cache.store(key, labels, feats)
        return labels, feats

    def extract_features(self, partition: str = "train"):
        """(labels, logits, features) for a split, with logits from the
        current model (ref: trainers/adapter.py:886-926)."""
        print(f"Extracting features from: {partition}")
        loader = {
            "train": self.dm.eval_train_loader()
            if hasattr(self.dm, "eval_train_loader")
            else self.train_loader_x,
            "val": self.val_loader,
            "test": self.test_loader,
        }[partition]
        labels, feats = self.encode_images_batched(
            loader, cacheable=partition in ("val", "test"))
        with torch.no_grad():
            logits = self.predict_logits(
                torch.from_numpy(feats).to(self.device)
            ).cpu().numpy()
        return labels, logits, feats

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def before_train(self):
        if self.config.resume:
            self.start_epoch = self.load_model(self.config.resume)
        if getattr(self.config.train, "enable_tensorboard", False):
            writer_dir = Path(self.output_dir) / "tensorboard"
            writer_dir.mkdir(parents=True, exist_ok=True)
            self.init_writer(str(writer_dir))
        self.time_start = time.time()

    def init_writer(self, log_dir: str) -> None:
        """TensorBoard scalars through tensorboardX (ref:
        utils/trainer.py:331-345)."""
        if self._writer is None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                print("tensorboardX unavailable; scalar logging disabled")
                return
            print(f"Initialize tensorboard (log_dir={log_dir})")
            self._writer = SummaryWriter(log_dir=log_dir)

    def write_scalar(self, tag: str, value, global_step=None) -> None:
        """A TensorBoard scalar; nothing without a writer."""
        if self._writer is not None and isinstance(value, (int, float)):
            self._writer.add_scalar(tag, value, global_step)

    def close_writer(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def after_train(self):
        print("Finish training")
        if not getattr(self.config, "no_test", False):
            if getattr(self.config, "final_model", "last") == "best_val":
                print("Deploy the model with the best val performance")
                self.load_model(self.output_dir)
            else:
                print("Deploy the last-epoch model")
            self.test()
        if self.time_start is not None:
            elapsed = str(datetime.timedelta(seconds=round(time.time() - self.time_start)))
            print(f"Elapsed: {elapsed}")
        self.close_writer()

    def before_epoch(self):
        pass

    def after_epoch(self):
        last = (self.epoch + 1) == self.max_epoch
        freq = int(getattr(self.config.train, "checkpoint_freq", 0))
        meet_freq = freq > 0 and (self.epoch + 1) % freq == 0
        if (meet_freq or last) and getattr(
            self.config.train, "enable_adapter_checkpoints", False
        ):
            self.save_model(self.epoch, self.output_dir)
        # best-val tracking: the reference defines the best_val deploy but
        # never writes model-best (ref quirk, utils/trainer.py); as in the JAX
        # package, val is evaluated each epoch and the best state kept
        if (
            getattr(self.config, "final_model", "last") == "best_val"
            and self.val_loader is not None
            and len(self.dm.dataset.val or []) > 0
        ):
            if self._val_feature_memo is None:
                labels, feats = self.encode_images_batched(self.val_loader,
                                                           cacheable=True)
                self._val_feature_memo = (labels, torch.from_numpy(feats).to(self.device))
            labels, feats = self._val_feature_memo
            with torch.no_grad():
                logits = self.predict_logits(feats).cpu().numpy()
            acc = compute_accuracy(logits, labels)[0]
            if acc > self._best_val_acc:
                self._best_val_acc = acc
                self.save_model(self.epoch, self.output_dir, model_name="model-best")
                print(f"New best val accuracy: {acc:.2f} (epoch {self.epoch + 1})")

    def train(self):
        with maybe_trace("train", device=self.device):
            self.build_model()
            self.before_train()
            with phase_timer("train_epochs", device=self.device):
                for self.epoch in range(self.start_epoch, self.max_epoch):
                    self.before_epoch()
                    self.run_epoch()
                    self.after_epoch()
            self.after_train()

    def run_epoch(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # evaluation + metrics.json
    # ------------------------------------------------------------------
    def compute_zero_shot_block(self, logits: np.ndarray, labels: np.ndarray):
        """Zero-shot metrics block recorded before training
        (ref: trainers/adapter.py:589-611)."""
        zs_acc = compute_accuracy(logits, labels)[0]
        zs_ece, zs_bins = compute_ece_with_bins(logits, labels)
        zs_aece, zs_abins = compute_aece_with_bins(logits, labels)
        print("Zero-Shot accuracy on test: " + str(round(zs_acc, 2)))
        print("Zero-Shot ECE on test: " + str(round(zs_ece, 2)))
        print("Zero-Shot AECE on test: " + str(round(zs_aece, 2)))
        self.zero_shot_metrics = {
            "top1_acc": zs_acc,
            "ece": zs_ece,
            "aece": zs_aece,
            "calibration": zs_bins,
            "adaptive_calibration": zs_abins,
        }
        return self.zero_shot_metrics

    def eval_logits_labels(self, split: str = "test"):
        labels, feats = self.encode_images_batched(
            self.test_loader if split == "test" else self.val_loader,
            cacheable=True,
        )
        with torch.no_grad():
            logits = self.predict_logits(
                torch.from_numpy(feats).to(self.device)
            ).cpu().numpy()
        return logits, labels

    def test(self, split: Optional[str] = None) -> float:
        split = split or "test"
        print(f"Evaluate on the *{split}* set")
        logits, labels = self.eval_logits_labels(split)
        accuracy = compute_accuracy(logits, labels)[0]
        macro_f1 = compute_macro_f1(logits, labels)
        ece = compute_ece(logits, labels)
        aece = compute_aece(logits, labels)
        _, ece_bins = compute_ece_with_bins(logits, labels)
        _, aece_bins = compute_aece_with_bins(logits, labels)
        # both spellings appear in the reference pipeline; write the superset
        results = {
            "accuracy": accuracy,
            "top1_acc": accuracy,
            "macro_f1": macro_f1,
            "ece": ece,
            "aece": aece,
            "calibration": ece_bins,
            "adaptive_calibration": aece_bins,
        }
        print("=> result")
        print(f"* total: {len(labels):,}")
        print(f"* correct: {int((logits.argmax(1) == labels).sum()):,}")
        print(f"* accuracy: {accuracy:.1f}%")
        print(f"* error: {100 - accuracy:.1f}%")
        print(f"* macro_f1: {macro_f1:.1f}%")
        print(f"* ECE: {ece:.2f}%")
        print(f"* AECE: {aece:.2f}%")
        self.write_run_summary_json(results, start_time=self.time_start or time.time())
        for key, value in results.items():
            self.write_scalar(f"{split}/{key}", value, self.epoch)
        return accuracy

    def write_run_summary_json(self, metrics: Dict, start_time: float) -> None:
        """metrics.json with the reference schema (ref: utils/trainer.py:599-639)."""
        from clip_gp_tpu_torch.core.config import config_to_dict

        out_dir = Path(self.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        payload = {
            "timestamp": datetime.datetime.now().isoformat(),
            "dataset": self.config.dataset.name,
            "shots": int(self.config.dataset.num_shots),
            "seed": int(self.config.seed),
            "method": infer_method_name(self.config),
            "backbone": self.config.model.backbone_name,
            "zero_shot": self.zero_shot_metrics,
            "metrics": metrics,
            "config": config_to_dict(self.config),
            "output_dir": str(out_dir),
            "train_time_s": float(max(0.0, time.time() - start_time)),
        }
        with (out_dir / "metrics.json").open("w") as f:
            json.dump(payload, f, indent=2)

    # ------------------------------------------------------------------
    # checkpoints (npz of the small trainable state)
    # ------------------------------------------------------------------
    def extra_checkpoint_state(self) -> Dict:
        """Non-trainable arrays a cross-dataset reload needs (e.g. GP buffers
        derived from the *training* dataset's templates), saved once beside
        the per-epoch checkpoints."""
        return {}

    def save_model(
        self, epoch: int, output_dir: str, model_name: Optional[str] = None
    ) -> None:
        state = self.trainable_state()
        if not state:
            return
        save_dir = Path(output_dir) / "adapter"
        save_dir.mkdir(parents=True, exist_ok=True)
        name = model_name or f"{CKPT_PREFIX}{epoch + 1}"
        extra = self.extra_checkpoint_state()
        if extra and not getattr(self, "_extra_saved", False):
            np.savez_compressed(
                save_dir / "extra_state.npz", **_flatten({"extra": extra})
            )
            self._extra_saved = True
        flat = _flatten({"state": state})
        dataset = getattr(self.dm, "dataset", None)
        classnames = getattr(dataset, "classnames", None)
        if classnames is not None:
            # label-ordered classnames: the key for cross-dataset row remaps
            flat["__classnames__"] = np.asarray(list(classnames), dtype=np.str_)
        class_keys = getattr(dataset, "class_keys", None)
        if class_keys is not None:
            flat["__class_keys__"] = np.asarray(list(class_keys), dtype=np.str_)
        np.savez_compressed(
            save_dir / f"{name}.npz", __epoch__=np.asarray(epoch + 1), **flat
        )
        print(f"Checkpoint saved to {save_dir / name}.npz")

    def remap_trainable_state(self, state: Dict, extra: Dict, idx) -> Dict:
        """Select the per-class rows ``idx`` (eval-label order → trained-label
        index) out of a checkpoint trained on a superset of classes (OOD
        evaluation on class subsets, BASELINE config #5). Heads with
        per-class state override this."""
        raise ValueError(
            f"{type(self).__name__}: checkpoint was trained on different "
            "classes and this trainer has no cross-dataset remap"
        )

    def adopt_reference_state(self, state: Dict, extra: Dict) -> Dict:
        """Check and adopt a converted reference checkpoint
        (``runtime/ref_checkpoint.py``) before ``load_trainable_state``. The
        default takes class-agnostic state as it is; a trainer whose
        converted state carries companion buffers (the Adapter's GP)
        overrides this."""
        if extra:
            raise ValueError(
                f"{type(self).__name__} cannot adopt reference extra state "
                f"{sorted(extra)}"
            )
        return state

    def load_model(self, model_dir: str, epoch: Optional[int] = None) -> int:
        """Load the run's npz checkpoint into the trainer, else its
        reference-format checkpoint; returns its epoch, or 0 when
        ``<model_dir>/adapter`` holds neither."""
        path = resolve_checkpoint_path(model_dir, epoch)
        if path is None:
            from clip_gp_tpu_torch.runtime import ref_checkpoint

            ref_path = ref_checkpoint.resolve_reference_checkpoint_path(model_dir, epoch)
            if ref_path is not None:
                print(f"Loading reference checkpoint from {ref_path}")
                state, extra, ep = ref_checkpoint.convert_reference_checkpoint(
                    ref_path, getattr(self.config, "trainer_name", ""))
                self.load_trainable_state(self.adopt_reference_state(state, extra))
                return ep
            print(f"No checkpoint found under {Path(model_dir) / 'adapter'}")
            return 0
        print(f"Loading checkpoint from {path}")

        def _str_list(data, name):
            return [str(c) for c in data[name]] if name in data.files else None

        with np.load(path, allow_pickle=False) as data:
            epoch_loaded = int(data["__epoch__"])
            saved_classnames = _str_list(data, "__classnames__")
            saved_keys = _str_list(data, "__class_keys__")
            flat = {
                k: data[k]
                for k in data.files
                if k not in ("__epoch__", "__classnames__", "__class_keys__")
            }
        tree = _unflatten(flat)
        state = tree["state"]
        dataset = getattr(self.dm, "dataset", None)
        cur = getattr(dataset, "classnames", None)
        cur_keys = getattr(dataset, "class_keys", None)
        idx = None
        if saved_keys is not None and cur_keys is not None:
            # unique per-class keys (ImageNet wnids): exact even where
            # classnames repeat ('crane' twice in the 1000-class vocabulary)
            if list(cur_keys) != saved_keys:
                idx = self._remap_index(saved_keys, list(cur_keys), kind="class keys")
        elif (
            saved_classnames is not None
            and cur is not None
            and list(cur) != saved_classnames
        ):
            idx = self._remap_index(saved_classnames, list(cur), kind="classnames",
                                    forbid_duplicates=True)
        if idx is not None:
            print(
                f"Remapping per-class state: {len(saved_classnames or saved_keys)}"
                f" trained -> {len(idx)} eval classes"
            )
            extra = tree.get("extra", {})
            if not extra:
                extra_path = path.parent / "extra_state.npz"
                if extra_path.exists():
                    with np.load(extra_path, allow_pickle=False) as d:
                        extra = _unflatten({k: d[k] for k in d.files}).get("extra", {})
            state = self.remap_trainable_state(state, extra, idx)
        self.load_trainable_state(state)
        return epoch_loaded

    @staticmethod
    def _remap_index(saved, cur, kind, forbid_duplicates=False):
        """Eval-label-ordered indices into the trained class axis."""
        pos = {}
        dups = set()
        for i, c in enumerate(saved):
            if c in pos:
                dups.add(c)
            pos[c] = i
        missing = [c for c in cur if c not in pos]
        if missing:
            raise ValueError(
                f"checkpoint was trained on {kind} that do not cover this "
                f"dataset; missing {len(missing)}, e.g. {missing[:3]}"
            )
        if forbid_duplicates:
            # a name-keyed remap is ambiguous when a needed name repeats in
            # the trained vocabulary: either row would silently degrade it
            ambiguous = sorted(dups & set(cur))
            if ambiguous:
                raise ValueError(
                    f"cannot remap per-class state: {kind} {ambiguous[:3]} "
                    "appear more than once in the trained vocabulary; "
                    "evaluate on the full class set instead"
                )
        return np.asarray([pos[c] for c in cur], dtype=np.int64)
