"""Plain reference of the Adapter + GP head, trial-batched: the loss, its
gradient and the AdamW steps of ``configs/trainers/gp.yaml``'s recipe, and
the eval logits. Written from the method's equations, not from the port:

- PCA of all K*M template embeddings to ``pca_dim`` dims by an SVD of the
  centred matrix; per class, the inducing points are the M projected
  templates and one learnable token that starts at the projected class mean;
- the linear kernel ``var * <a, b>`` with ``var = softplus(raw_variance)``;
- the whitened variational predictive at the M templates:
  ``L = chol(K_zz + jitter I)``, ``A = L^-1 K_zx``,
  ``mean = A^T m + cls_bias + mean(tmp_bias)``,
  ``cov = K_xx + jitter I + A^T (S - I) A``, ``S = tril(Lq) tril(Lq)^T``;
  a Cholesky whose jittered matrix is not positive definite takes the
  larger jitter ``max(10 jitter, 1e-2 max diag)`` (gpytorch's
  ``psd_safe_cholesky`` role);
- samples ``f = mean + chol(cov + 1e-6 I) eps``, template weights
  ``sparsemax(f)``, prototypes ``w @ templates``;
- the loss per trial: the MC mean of the cross-entropy of
  ``scale * cos(W x, prototype)``, plus ``beta * KL(q(u) || N(0, I))`` summed
  over classes, plus ``||W - I||^2 * l2_lambda / shots``.

Every function takes the dtype to compute in: float64 is the reference,
float32 with TF32 switched on (``tf32``) is the control of ``control.py``.
Nothing here imports the port.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def setup(text: torch.Tensor, pca_dim: int, dtype=torch.float64) -> Tree:
    """The GP's frozen part from templates [K, M, D]: the PCA (mean, basis),
    the projected templates and the projected class means."""
    k, m, d = text.shape
    e = text.to(dtype)
    x = e.reshape(k * m, d)
    mu = x.mean(dim=0)
    _, _, vh = torch.linalg.svd(x - mu, full_matrices=False)
    basis = vh[: min(pca_dim, k * m, d)].T
    return {"templates": e, "templates_red": ((x - mu) @ basis).reshape(k, m, -1),
            "cls_mean_red": (e.mean(dim=1) - mu) @ basis}


def init_state(frozen: Tree, t: int, d_feat: int) -> Tree:
    """One trial's initial trainable state, repeated over ``t`` trials: the
    identity projection, the token at the class mean, uniform template
    weights as the variational mean (log 1/M, 0 for the token), S = I."""
    red = frozen["templates_red"]
    k, m, _ = red.shape
    dt, dev = red.dtype, red.device
    vm = torch.zeros(k, m + 1, dtype=dt, device=dev)
    vm[:, :m] = math.log(1.0 / m)
    one = {
        "visual_proj": torch.eye(d_feat, dtype=dt, device=dev),
        "gp/inducing_token": frozen["cls_mean_red"][:, None, :],
        "gp/variational_mean": vm,
        "gp/chol_variational_covar": torch.eye(m + 1, dtype=dt, device=dev).expand(k, m + 1, m + 1),
        "gp/cls_bias": torch.zeros(k, 1, dtype=dt, device=dev),
        "gp/tmp_bias": torch.zeros(1, m, dtype=dt, device=dev),
        "gp/A": torch.eye(red.shape[-1], dtype=dt, device=dev),
        "gp/raw_variance": torch.zeros(k, dtype=dt, device=dev),
    }
    return {n: v[None].expand((t,) + tuple(v.shape)).clone() for n, v in one.items()}


def _safe_chol(a: torch.Tensor, jitter: float) -> torch.Tensor:
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    _, info = torch.linalg.cholesky_ex(a.detach() + jitter * eye)
    big = torch.clamp(1e-2 * a.detach().diagonal(dim1=-2, dim2=-1).amax(-1), min=10 * jitter)
    j = torch.where(info == 0, torch.full_like(big, jitter), big)
    return torch.linalg.cholesky(a + j[..., None, None] * eye)


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """Projection of the last axis onto the simplex (Martins & Astudillo);
    autograd gives its Jacobian."""
    zs, _ = torch.sort(z, dim=-1, descending=True)
    ks = torch.arange(1, z.shape[-1] + 1, dtype=z.dtype, device=z.device)
    cs = zs.cumsum(-1)
    kz = (1 + ks * zs > cs).sum(-1, keepdim=True)
    tau = (cs.gather(-1, kz - 1) - 1) / kz.to(z.dtype)
    return (z - tau).clamp(min=0)


def prototypes(p: Tree, frozen: Tree, eps: torch.Tensor, jitter: float = 1e-4) -> torch.Tensor:
    """MC prototypes [T, S, K, D] from eps [T, S, K, M]."""
    red = frozen["templates_red"]  # [K, M, d]
    t = eps.shape[0]
    k, m, _ = red.shape
    x = red[None].expand(t, -1, -1, -1)
    z = torch.cat([x, p["gp/inducing_token"]], dim=2)  # [T, K, M+1, d]
    var = torch.nn.functional.softplus(p["gp/raw_variance"])[..., None, None]
    k_zz = var * z @ z.transpose(-1, -2)
    k_zx = var * z @ x.transpose(-1, -2)
    k_xx = var * x @ x.transpose(-1, -2)
    a = torch.linalg.solve_triangular(_safe_chol(k_zz, jitter), k_zx, upper=False)
    lq = torch.tril(p["gp/chol_variational_covar"])
    s_eye = lq @ lq.transpose(-1, -2) - torch.eye(m + 1, dtype=red.dtype, device=red.device)
    tail = p["gp/cls_bias"] + p["gp/tmp_bias"].mean(dim=-1, keepdim=True)  # [T, K, 1]
    mean = (a * p["gp/variational_mean"][..., None]).sum(-2) + tail
    cov = (k_xx + jitter * torch.eye(m, dtype=red.dtype, device=red.device)
           + a.transpose(-1, -2) @ s_eye @ a)
    lf = _safe_chol(cov, 1e-6)  # [T, K, M, M]
    f = mean[:, None] + torch.einsum("tkij,tskj->tski", lf, eps)
    return torch.einsum("tskm,kmd->tskd", sparsemax(f), frozen["templates"])


def kl(p: Tree) -> torch.Tensor:
    """Sum over classes of KL(N(m, S) || N(0, I)), per trial [T]."""
    lq = torch.tril(p["gp/chol_variational_covar"])
    m = p["gp/variational_mean"]
    logdet = 2 * torch.log(lq.diagonal(dim1=-2, dim2=-1).abs() + 1e-20).sum(-1)
    per_class = 0.5 * ((lq ** 2).sum((-1, -2)) + (m ** 2).sum(-1) - m.shape[-1] - logdet)
    return per_class.sum(-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def loss(p: Tree, frozen: Tree, feats: torch.Tensor, labels: torch.Tensor,
         eps: torch.Tensor, hp: Dict[str, torch.Tensor], scale: float,
         shots: int) -> torch.Tensor:
    """Per-trial losses [T] of one batch: feats [T, B, D], labels [T, B]."""
    w = p["visual_proj"]
    f = _unit(feats.to(w.dtype) @ w.transpose(-1, -2))
    protos = _unit(prototypes(p, frozen, eps.to(w.dtype)))
    logits = scale * torch.einsum("tbd,tskd->tsbk", f, protos)
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    ce = -logp.gather(-1, idx).mean(dim=(1, 2, 3))
    eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
    l2 = ((w - eye) ** 2).sum((-1, -2)) * (hp["l2_lambda"] / shots)
    return ce + hp["gp_beta"] * kl(p) + l2


def eval_logits(p: Tree, frozen: Tree, feats: torch.Tensor, eps: torch.Tensor,
                scale: float) -> torch.Tensor:
    """[T, N, K]: ``scale * cos(W x, mean of the normalised MC prototypes)``
    on features [N, D] that every trial shares."""
    w = p["visual_proj"]
    f = _unit(feats.to(w.dtype) @ w.transpose(-1, -2))
    protos = _unit(prototypes(p, frozen, eps.to(w.dtype))).mean(dim=1)
    return scale * f @ protos.transpose(-1, -2)


class AdamW:
    """``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` per leaf, with a
    per-trial lr [T]."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.t = 0
        self.m: Tree = {}
        self.v: Tree = {}

    @torch.no_grad()
    def step(self, p: Tree, grads: Tree, lrs: Dict[str, torch.Tensor]) -> Tree:
        self.t += 1
        out = {}
        for n, x in p.items():
            g = grads[n]
            self.m[n] = self.b1 * self.m.get(n, torch.zeros_like(g)) + (1 - self.b1) * g
            self.v[n] = self.b2 * self.v.get(n, torch.zeros_like(g)) + (1 - self.b2) * g * g
            mh = self.m[n] / (1 - self.b1 ** self.t)
            vh = self.v[n] / (1 - self.b2 ** self.t)
            lr = lrs[n].reshape((-1,) + (1,) * (x.dim() - 1))
            out[n] = x - lr * (mh / (vh.sqrt() + self.eps) + self.wd * x)
        return out


def cosine_factor(epoch: int, epochs: int) -> float:
    """The recipe's cosine schedule, as a factor of the base lr."""
    return (1 + math.cos(math.pi * min(epoch, epochs) / max(epochs, 1))) / 2
