"""What the script modules share: where their artifacts go, the fence that
ends a timed window, and the synthetic-tree configs their benches train on.

Artifacts go to ``build/scripts/`` under the repository root (ignored by
git), never to the root, where the JAX package's scripts keep theirs.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import tempfile
from pathlib import Path
from typing import Iterator, Optional

import torch

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = REPO / "build" / "scripts"


def write_artifact(name: str, payload: dict) -> Path:
    """``payload`` as one JSON line in ``ARTIFACTS/name``."""
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    path = ARTIFACTS / name
    path.write_text(json.dumps(payload) + "\n")
    return path


def read_artifact(name: str) -> Optional[dict]:
    path = ARTIFACTS / name
    return json.loads(path.read_text()) if path.exists() else None


def sync(device) -> None:
    """End a timed window: the card has run everything queued before it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def bench_context(prefix: str, **env: str) -> Iterator[str]:
    """A bench's run: the datasets and trainers registered, a temporary
    directory (yielded, removed at the end) and, for the duration, random
    weights (a bench's rate does not depend on them) and each of ``env``,
    where the caller has not set the variable itself."""
    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401

    env = {"CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS": "1", **env}
    added = [name for name in env if name not in os.environ]
    for name in added:
        os.environ[name] = env[name]
    try:
        with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
            yield tmp
    finally:
        for name in added:
            os.environ.pop(name, None)


def synthetic_config(root: str, shots: int, backbone: str, image_size: int,
                     batch_train: int, batch_test: int = 128,
                     workers: Optional[int] = None):
    """A Config over the Synthetic tree at ``root``: the part every bench
    sets the same way."""
    from clip_gp_tpu_torch.core.config import Config

    c = Config()
    c.dataset.name = "Synthetic"
    c.dataset.root = root
    c.dataset.num_shots = shots
    c.model.backbone_name = backbone
    c.input.size = (image_size, image_size)
    c.dataloader.batch_size_train = batch_train
    c.dataloader.batch_size_test = batch_test
    c.dataloader.num_workers = (max(2, os.cpu_count() or 2) if workers is None
                                else workers)
    c.train.print_freq = 10_000
    c.seed = 1
    return c


def gp_config(root: str, shots: int, backbone: str, image_size: int,
              epochs: int, workers: Optional[int] = None):
    """The flagship Adapter + GP trial of the JAX benches (8 templates, a
    linear-kernel GP, S=30/300 MC samples, batch 128)."""
    c = synthetic_config(root, shots, backbone, image_size, 128, workers=workers)
    c.adapter.num_templates = 8
    c.adapter.use_gp = True
    c.adapter.gp_kernel_type = "linear"
    c.adapter.gp_num_mc_samples_train = 30
    c.adapter.gp_num_mc_samples_eval = 300
    c.adapter.clip_adapter_epochs = epochs
    c.optim.max_epoch = epochs
    return c


def prompt_config(root: str, method: str, shots: int, backbone: str,
                  image_size: int, epochs: int, n_ctx: int,
                  workers: Optional[int] = 8):
    """A CoOp or CoCoOp trial of the JAX benches (SGD at lr 0.002, batch
    32)."""
    c = synthetic_config(root, shots, backbone, image_size, 32, workers=workers)
    c.trainer_name = method
    c.adapter.n_ctx = n_ctx
    c.adapter.clip_adapter_epochs = epochs
    c.optim.name = "sgd"
    c.optim.lr = 0.002
    c.optim.max_epoch = epochs
    c.train.print_freq = 10**9
    return c


def sample_splits(config, seeds) -> None:
    """Write every seed's few-shot split cache, so that no timed run pays
    the one-time sampling."""
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager

    for s in seeds:
        cfg = copy.deepcopy(config)
        cfg.seed = s
        set_random_seed(s)
        build_data_manager(cfg)
