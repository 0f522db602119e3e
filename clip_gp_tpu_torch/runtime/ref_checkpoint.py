"""Reference-framework checkpoints (``model.pth.tar-*``) onto the port's
trainable state, as the JAX package's ``runtime/ref_checkpoint.py``.

The reference saves ``{"state_dict": model.state_dict(), "epoch": e+1,
"optimizer": ..., "scheduler": ...}`` with ``torch.save`` under
``<run>/adapter/model.pth.tar-<epoch>`` (ref: utils/trainer.py:347-374) and
resolves ``model-best.pth.tar``, else the highest epoch, on load (ref:
utils/trainer.py:376-399). ``BaseTrainer.load_model`` converts such a file
when the run directory holds no npz, so ``--eval-only --model-dir
<reference run>`` serves a reference-trained model.

- The frozen towers inside the state dict are ignored: every reference
  trainer freezes ``image_encoder``/``text_encoder``/``logit_scale``, so
  they equal the pretrained CLIP weights the port loads itself.
- GP runs: the variational state lives in the checkpoint's PCA basis (torch
  SVD, whose column signs differ from numpy's), so the GP buffers come from
  the checkpoint too. ``_pca_W``/``_pca_mean`` are plain attributes in the
  reference and not saved; they are rebuilt from the saved
  ``_templates``/``_templates_red``: μ is the mean over all K·M template
  embeddings, and W is the fp64 principal subspace of ``X − μ`` rotated
  onto the checkpoint's basis by an orthogonal Procrustes fit (no
  small-singular-value amplification, unlike a plain least-squares solve).
- Tip-Adapter: the reference never saves one (its trainer leaves
  ``self.model`` unset, so ``save_model`` returns at once, ref:
  utils/trainer.py:348-350); a clear error says so.
- Optimizer and scheduler state are not converted: resuming training from a
  reference checkpoint restarts the optimizer, as in the JAX package.
- Reference checkpoints carry no classnames, so the cross-dataset row remap
  is not available for them.

The file is read with ``torch.load(weights_only=True)``: a checkpoint of the
reference's shape (tensors, ints, and the state dicts of a torch optimizer
and scheduler) loads so, and no pickled code runs. A file that needs more
than that is refused with torch's own error rather than unpickled.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from clip_gp_tpu_torch.runtime.checkpoint import find_run_checkpoint

REF_CKPT_PREFIX = "model.pth.tar-"


def resolve_reference_checkpoint_path(model_dir, epoch: Optional[int] = None
                                      ) -> Optional[Path]:
    """Reference-format discovery: an explicit epoch, else model-best, else
    the highest-numbered (ref: utils/trainer.py:376-399). None if absent."""
    return find_run_checkpoint(model_dir, epoch, REF_CKPT_PREFIX, "",
                               "model-best.pth.tar")


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _require(sd: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(
            f"reference checkpoint is missing {key!r}; was it saved by a "
            "different trainer than this config's?"
        )
    return sd[key]


def _procrustes_pca(templates: np.ndarray, templates_red: np.ndarray):
    """(μ, W) with ``(X − μ)·W ≈ templates_red``, X the K·M templates."""
    d_full = templates.shape[-1]
    d_red = templates_red.shape[-1]
    x = templates.reshape(-1, d_full).astype(np.float64)
    mu = x.mean(axis=0)
    xc = x - mu
    y = templates_red.reshape(-1, d_red).astype(np.float64)
    v = np.linalg.svd(xc, full_matrices=False)[2][:d_red].T  # [D, d]
    u_s, _, vt_s = np.linalg.svd((xc @ v).T @ y)
    return mu.astype(np.float32), (v @ (u_s @ vt_s)).astype(np.float32)


def _convert_adapter(sd) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Adapter CustomCLIP (ref: trainers/adapter.py:145-198): visual_proj and
    one of the GP weighter, template-weight logits or the linear head."""
    state: Dict[str, Any] = {"visual_proj": _require(sd, "visual_proj.weight")}
    extra: Dict[str, Any] = {}
    g = "gp_weighter."
    vd = g + "variational_strategy._variational_distribution."
    if vd + "variational_mean" in sd:
        templates = _require(sd, g + "_templates")  # [K, M, D]
        templates_red = _require(sd, g + "_templates_red")  # [K, M, d]
        m = templates.shape[1]
        gp: Dict[str, Any] = {
            "inducing_token": _require(sd, g + "variational_strategy.inducing_points")[:, m:, :],
            "variational_mean": sd[vd + "variational_mean"],
            "chol_variational_covar": _require(sd, vd + "chol_variational_covar"),
            "cls_bias": _require(sd, g + "mean_module.cls_bias"),
            "tmp_bias": _require(sd, g + "mean_module.tmp_bias"),
            # unused in the forward, kept for parity (ref:68-70)
            "A": _require(sd, g + "A.weight"),
        }
        if g + "covar_module.base_kernel.raw_lengthscale" in sd:  # rbf + scale
            gp["raw_lengthscale"] = sd[g + "covar_module.base_kernel.raw_lengthscale"]
            gp["raw_outputscale"] = _require(sd, g + "covar_module.raw_outputscale")
        elif g + "covar_module.raw_lengthscale" in sd:  # matern ν=½
            gp["raw_lengthscale"] = sd[g + "covar_module.raw_lengthscale"]
        elif g + "covar_module.raw_variance" in sd:  # linear
            gp["raw_variance"] = sd[g + "covar_module.raw_variance"][:, 0]
        else:
            raise KeyError(
                "reference GP checkpoint has no recognizable kernel "
                "parameters under gp_weighter.covar_module.*"
            )
        state["gp"] = gp
        mu, w = _procrustes_pca(templates, templates_red)
        extra["gp_buffers"] = {
            "templates": templates,
            "templates_red": templates_red,
            "pca_mean": mu,
            "pca_W": w,
            "f0": _require(sd, g + "mean_module.f0"),
        }
    elif "template_weights" in sd:
        state["template_logits"] = sd["template_weights"]
    elif "template_weight_linear.weight" in sd:
        # torch Linear weight [1, D] → the port's [D, 1] column
        state["template_weight_linear"] = sd["template_weight_linear.weight"].T
    return state, extra


def _convert_clip_adapter(sd) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """CLIP-Adapter (ref: trainers/clip_adapter.py:16-70): the bottleneck MLP
    and the classifier buffer (which the GP pre-stage overwrote in place
    with its prototypes, ref:286-290, so GP runs convert through it too)."""
    return {
        "adapter": {
            "fc1": _require(sd, "adapter.fc1.weight").T,
            "fc2": _require(sd, "adapter.fc2.weight").T,
        },
        "clip_weights": _require(sd, "clip_weights"),
    }, {}


def _convert_taskres(sd) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """TaskRes (ref: trainers/taskres.py:35-47): the frozen base text
    features (a buffer, which carries the GP and enhanced-base variants)
    and the residuals."""
    return {
        "residuals": _require(sd, "taskres_learner.text_feature_residuals"),
        "base_text_features": _require(sd, "taskres_learner.base_text_features"),
    }, {}


def _convert_coop(sd) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """CoOp (ref: trainers/adapter_coop.py:14-63): the learnable context
    ([n_ctx, dim] shared or [K, n_ctx, dim] class-specific); the prompt
    buffers are rebuilt from the classnames and the CLIP weights."""
    return {"ctx": _require(sd, "prompt_learner.ctx")}, {}


def _convert_cocoop(sd) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """CoCoOp (ref: trainers/adapter_cocoop.py:14-60): the context and the
    2-layer meta-net (torch Linear [out, in] → the port's [in, out])."""
    p = "prompt_learner."
    return {
        "ctx": _require(sd, p + "ctx"),
        "meta_fc1": {"w": _require(sd, p + "meta_net.0.weight").T,
                     "b": _require(sd, p + "meta_net.0.bias")},
        "meta_fc2": {"w": _require(sd, p + "meta_net.2.weight").T,
                     "b": _require(sd, p + "meta_net.2.bias")},
    }, {}


_CONVERTERS = {
    "Adapter": _convert_adapter,
    "CLIP-Adapter": _convert_clip_adapter,
    "Adapter-CLIP-Adapter": _convert_clip_adapter,
    "TaskRes": _convert_taskres,
    "Adapter-CoOp": _convert_coop,
    "CoOp": _convert_coop,
    "Adapter-CoCoOp": _convert_cocoop,
    "CoCoOp": _convert_cocoop,
}

_NEVER_SAVED = ("Tip-Adapter", "Adapter-TipA", "Adapter-TipA-F", "Tip-Adapter-F")


def convert_reference_checkpoint(path, trainer_name: str
                                 ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """(trainable state, extra state, epoch) of a reference checkpoint, as
    numpy arrays."""
    if trainer_name in _NEVER_SAVED:
        raise ValueError(
            f"{trainer_name}: the reference never saves Tip-Adapter "
            "checkpoints (its trainer leaves self.model unset, so "
            "save_model is a no-op; ref: utils/trainer.py:348-350); "
            "there is no artifact to ingest"
        )
    conv = _CONVERTERS.get(trainer_name)
    if conv is None:
        raise ValueError(
            f"no reference-checkpoint converter for trainer {trainer_name!r} "
            f"(supported: {sorted(_CONVERTERS)})"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: _np(v) for k, v in ckpt["state_dict"].items() if torch.is_tensor(v)}
    state, extra = conv(sd)
    return state, extra, int(ckpt.get("epoch", 0))
