"""Shared building blocks for the adaptation methods.

The text side (per-class·template embeddings, zero-shot classifier), the
few-shot template-weight initialization, the cosine-logit heads and losses,
and the batched image-encode loop (ref: utils/trainer.py:178-237,
trainers/adapter.py:30-142), as the JAX package's ``methods/common.py``
defines them. PyTorch runs eagerly, so the JAX package's scanned quiet-epoch
machinery has no counterpart here.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from clip_gp_tpu_torch.models.tokenizer import tokenize
from clip_gp_tpu_torch.runtime.profiling import span


def extract_device_batch() -> int:
    """Images per device batch of an extraction:
    ``CLIP_GP_TPU_TORCH_EXTRACT_DEVICE_BATCH``, default 512."""
    return max(1, int(os.environ.get("CLIP_GP_TPU_TORCH_EXTRACT_DEVICE_BATCH", "512")))


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def encode_templates(
    model,
    classnames: List[str],
    templates: List[str],
    batch_size: int = 256,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Text embeddings [K, M, D] for every class × template, on the model's
    device: all K·M prompts tokenize at once and encode in batches of
    ``batch_size`` through the frozen text tower (no autograd)."""
    k, m = len(classnames), len(templates)
    prompts = [t.format(name) for name in classnames for t in templates]
    device = model.token_embedding.device
    tokens = torch.from_numpy(tokenize(prompts)).to(device)  # [K*M, 77]
    with torch.no_grad():
        feats = torch.cat([
            model.encode_text(tokens[i: i + batch_size], compute_dtype)
            for i in range(0, tokens.shape[0], batch_size)
        ])
    return feats.reshape(k, m, -1)


def zero_shot_classifier(text_embeddings: torch.Tensor) -> torch.Tensor:
    """[K,M,D] → [D,K] zero-shot weights: per-template L2-normalize, average
    over templates, L2-normalize again (ref: utils/trainer.py:223-237)."""
    e = l2_normalize(text_embeddings)
    return l2_normalize(e.mean(dim=1)).T


def _template_scores(features, labels, text_embeddings, scale, num_classes):
    """Per-class per-template few-shot accuracy S[k,m]."""
    feats = l2_normalize(features)  # [N,D]
    protos = l2_normalize(text_embeddings)  # [K,M,D]
    logits = scale * torch.einsum("nd,kmd->nmk", feats, protos)  # [N,M,K]
    preds = logits.argmax(dim=-1)  # [N,M]
    correct = (preds == labels[:, None]).float()  # [N,M]
    onehot = F.one_hot(labels, num_classes).float()  # [N,K]
    sums = torch.einsum("nk,nm->km", onehot, correct)
    counts = onehot.sum(dim=0).clamp(min=1.0)[:, None]
    return sums / counts


def prefit_full_set_features(config, trainer):
    """(features [N,D] numpy, labels [N]) of the full train split, for
    template-weight scoring with ``TRAINER.ADAPTER.PREFIT_ON_FULL_SET``, or
    None when the flag is unset (JAX ``methods/common.py:79-121``).

    The reference folds this branch into ``_get_template_weights``
    (ref: trainers/adapter.py:71-100), so it applies to every warm start: the
    Adapter's own and the GP pre-stages of CLIP-Adapter, TaskRes and
    Tip-Adapter. The split is built with ``num_shots = 0`` and encoded under
    the train transform, in order.

    Deliberately narrower than the JAX package, which falls back to the
    few-shot features on any exception: here only building the full split's
    dataset and loader may fail that way (a ``[WARN]``, then None). The
    encode is outside the catch, so an error of the image tower or a kernel
    (on a GPU) propagates instead of hiding behind the fallback."""
    if not bool(getattr(config.adapter, "prefit_on_full_set", False)):
        return None
    import copy

    from clip_gp_tpu_torch.core.registry import build_dataset
    from clip_gp_tpu_torch.data.pipeline import BatchLoader

    try:
        cfg_full = copy.deepcopy(config)
        cfg_full.dataset.num_shots = 0
        loader = BatchLoader(
            build_dataset(cfg_full).train_x,
            trainer.dm.tfm_train,
            config.dataloader.batch_size_train,
            shuffle=False,
            drop_last=False,
            num_workers=config.dataloader.num_workers,
        )
    except Exception as e:  # the JAX package's fallback contract
        print(f"[WARN] prefit_on_full_set failed ({e}); "
              "falling back to few-shot features.")
        return None
    labels, feats = trainer.encode_images_batched(loader)
    print(f"[INFO] Prefit on full set: {len(feats)} samples used.")
    return feats, labels


def get_template_weights(
    config,
    text_embeddings: torch.Tensor,
    features: Optional[torch.Tensor],
    labels: Optional[torch.Tensor],
    logit_scale: float,
) -> torch.Tensor:
    """Per-class template weights [K,M], rows summing to 1
    (ref: trainers/adapter.py:48-142): uniform | val_weighted | top3 |
    minmax; the non-uniform methods score templates by per-class few-shot
    accuracy, then map the scores through softmax(log(S+eps))."""
    method = str(getattr(config.adapter, "template_init_method", "uniform")).lower()
    k, m = int(text_embeddings.shape[0]), int(text_embeddings.shape[1])
    device = text_embeddings.device
    if m == 0:
        return torch.zeros(k, 0, device=device)
    if method == "uniform" or features is None or labels is None:
        return torch.full((k, m), 1.0 / m, device=device)

    with torch.no_grad():
        scores = _template_scores(
            features, labels.long(), text_embeddings, float(logit_scale), k
        ).cpu().numpy()
    if method == "top3":
        top_k = min(3, m)
        top_idx = np.argsort(-scores.mean(axis=0))[:top_k]
        keep = np.zeros(m)
        keep[top_idx] = 1.0
        scores = scores * keep[None]
        zero_rows = scores.sum(axis=1) <= 1e-12
        scores[zero_rows] = keep / top_k
    elif method == "minmax":
        s_min = scores.min(axis=1, keepdims=True)
        s_max = scores.max(axis=1, keepdims=True)
        rng = s_max - s_min
        flat = rng <= 1e-12
        scaled = (scores - s_min) / np.clip(rng, 1e-12, None)
        scores = np.where(flat, 1.0 / m, scaled)
    logits = np.log(np.clip(scores, 1e-12, None))
    w = np.exp(logits - logits.max(axis=1, keepdims=True))
    w = w / w.sum(axis=1, keepdims=True)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def cosine_logits(features: torch.Tensor, prototypes: torch.Tensor, scale) -> torch.Tensor:
    """scale · cos(features, prototypes): [N,D] × [K,D] → [N,K], or with MC
    prototype samples [S,K,D] → mean over S of per-sample logits
    (ref: trainers/adapter.py:246-252), computed as one product with the
    mean normalised prototype (the MC mean is linear in it)."""
    f = l2_normalize(features)
    if prototypes.dim() == 3:
        return scale * f @ l2_normalize(prototypes).mean(dim=0).T
    return scale * f @ l2_normalize(prototypes).T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def mc_cross_entropy(features_norm, prototypes, labels, scale) -> torch.Tensor:
    """Mean over S of CE(scale · f̂ · p̂_sᵀ, labels) — the MC-averaged loss
    (ref: trainers/adapter.py:401-428); the eval path averages logits."""
    p = l2_normalize(prototypes)  # [S,K,D]
    logits = scale * torch.einsum("nd,skd->snk", features_norm, p)  # [S,N,K]
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long()[None, :, None].expand(logits.shape[0], -1, 1)
    return -logp.gather(2, idx).mean()


def extract_with(encode_fn, loader) -> Tuple[np.ndarray, np.ndarray]:
    """Run an image-encode function over a loader → (features [N, ...]
    float32, labels [N]).

    Loader batches are grouped into device batches of at least
    ``extract_device_batch()`` images: encoding is per image, so the
    grouping cannot change results, and larger launches keep the GPU fed.
    The loader batch size still sets the host decode granularity.
    ``encode_fn`` takes uint8 NHWC numpy images and returns a tensor.

    Spans (``runtime/profiling.py``): ``data.wait_batch`` while the loop
    waits for the loader's next batch, ``tower.issue`` around each
    ``encode_fn`` call (both with attribute ``images``) and ``data.to_host``
    around the final copy, which waits for the device."""
    feats, labels = [], []
    buf: list = []
    device_batch = extract_device_batch()

    def flush():
        imgs = buf[0] if len(buf) == 1 else np.concatenate(buf)
        with span("tower.issue", images=int(imgs.shape[0])):
            feats.append(encode_fn(imgs))
        buf.clear()

    batches = iter(loader)
    while True:
        with span("data.wait_batch") as waiting:
            batch = next(batches, None)
            if batch is None:
                waiting.discard()  # the loader's end, not a batch
            else:
                waiting.attrs["images"] = int(batch["img"].shape[0])
        if batch is None:
            break
        buf.append(batch["img"])
        labels.append(batch["label"])
        if sum(b.shape[0] for b in buf) >= device_batch:
            flush()
    if buf:
        flush()
    with span("data.to_host"):
        out = torch.cat(feats).float().cpu().numpy()
    return out, np.concatenate(labels)


def batch_slices(n: int, batch_size: int):
    """Full batches like the reference's drop_last loader; one batch when the
    dataset is smaller than batch_size (ref: trainers/adapter.py:722-745)."""
    if n <= batch_size:
        return [(0, n)]
    n_batches = n // batch_size
    return [(b * batch_size, (b + 1) * batch_size) for b in range(n_batches)]
