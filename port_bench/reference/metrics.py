"""Plain reference of the run summary's metrics, in percent: top-1
accuracy, macro-F1 over the classes that occur as labels or predictions,
ECE over 10 equal-width confidence bins ``(lo, hi]``, and AECE over 10
equal-count bins of the confidence-sorted images (edges rounded), both
with the softmax of the logits in float64."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _conf(logits: np.ndarray, labels: np.ndarray):
    z = logits.astype(np.float64)
    p = np.exp(z - z.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return p.max(axis=1), (p.argmax(axis=1) == labels).astype(np.float64)


def summary(logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    labels = np.asarray(labels, np.int64)
    pred = logits.argmax(axis=1)
    f1 = []
    for c in np.union1d(labels, pred):
        tp = np.sum((pred == c) & (labels == c))
        wrong = np.sum((pred == c) != (labels == c))
        f1.append(2 * tp / (2 * tp + wrong) if 2 * tp + wrong else 0.0)
    conf, hit = _conf(logits, labels)
    n = conf.size
    edges = np.linspace(0, 1, 11)
    ece = sum(abs(conf[m].mean() - hit[m].mean()) * m.sum() / n
              for m in ((conf > lo) & (conf <= hi) for lo, hi in zip(edges[:-1], edges[1:]))
              if m.any())
    order = np.argsort(conf, kind="stable")
    cuts = np.round(np.linspace(0, n, 11)).astype(np.int64)
    aece = sum(abs(conf[order][a:b].mean() - hit[order][a:b].mean()) * (b - a) / n
               for a, b in zip(cuts[:-1], cuts[1:]) if b > a)
    return {"top1_acc": 100.0 * float((pred == labels).mean()),
            "macro_f1": 100.0 * float(np.mean(f1)),
            "ece": 100.0 * float(ece), "aece": 100.0 * float(aece)}
