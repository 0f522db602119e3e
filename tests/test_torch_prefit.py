"""``TRAINER.ADAPTER.PREFIT_ON_FULL_SET`` in the port
(``methods/common.prefit_full_set_features``) against the JAX package, and
the module docstrings of what this slice ported.

- The Adapter with prefit on: both CLIs end to end on TEST-RN and the
  Synthetic dataset (template weights scored by ``val_weighted`` on the full
  train split, then learned template logits; deterministic, no
  augmentation): the same number of full-split samples, top-1 equal and the
  other metrics within 1e-3 (percentage points, as
  tests/test_torch_train_e2e.py).
- The deliberate narrowing of the JAX package's catch-all: a failure to
  build the full split's dataset falls back to the few-shot features with a
  ``[WARN]``, as in JAX; an error of the image encode propagates in the port,
  where the JAX package swallows it too.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.config import Config as JConfig  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.methods import common as jcommon  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core import registry as tregistry  # noqa: E402
from clip_gp_tpu_torch.core.config import Config as TConfig  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.methods import common as tcommon  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES  # noqa: E402

METRICS = ("top1_acc", "macro_f1", "ece", "aece")


def _argv(root, out, weights):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-RN", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "3",
        "--template-init-method", "val_weighted",
        "INPUT.SIZE", "(64, 64)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights),
        "TRAINER.ADAPTER.PREFIT_ON_FULL_SET", "True",
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "2",
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "1",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    weights = base / "test_rn.npz"
    arch = ARCHITECTURES["TEST-RN"]
    # written by the port; test_torch_resnet.py holds the format to the JAX one
    save_params_npz(str(weights), arch, init_clip_params(arch, seed=0, device="cpu"))
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        for side, cli, reset in (("jax", jax_cli, jax_reset_tee),
                                 ("port", port_cli, port_reset_tee)):
            out = base / side
            try:
                cli.main(_argv(base / f"data-{side}", out, weights))
            finally:
                reset()
            with (out / "metrics.json").open() as f:
                results[side] = {"metrics": json.load(f),
                                 "log": (out / "log.txt").read_text()}
    return results


def test_adapter_prefit_on_full_set_matches_jax(runs):
    j, t = runs["jax"]["metrics"], runs["port"]["metrics"]
    line = "[INFO] Prefit on full set: "
    j_line = [s for s in runs["jax"]["log"].splitlines() if s.startswith(line)]
    t_line = [s for s in runs["port"]["log"].splitlines() if s.startswith(line)]
    assert len(j_line) == 1 and t_line == j_line
    assert t["metrics"]["top1_acc"] == j["metrics"]["top1_acc"]
    for key in METRICS:
        assert t["metrics"][key] == pytest.approx(j["metrics"][key], abs=1e-3), key


class _Trainer:
    """What prefit reads of a trainer: the data manager's train transform and
    the image encode, here one that fails as a broken card would."""

    class dm:  # noqa: N801
        @staticmethod
        def tfm_train(img, rng=None):
            return np.zeros((8, 8, 3), np.uint8)

    def encode_images_batched(self, loader):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def _configs(root):
    out = []
    for cls in (JConfig, TConfig):
        c = cls()
        c.dataset.name, c.dataset.root = "Synthetic", str(root)
        c.adapter.prefit_on_full_set = True
        c.dataloader.num_workers = 0
        out.append(c)
    return out


def test_prefit_is_off_without_the_flag(tmp_path):
    config = TConfig()
    assert tcommon.prefit_full_set_features(config, _Trainer()) is None


def test_a_dataset_error_falls_back_with_a_warning(tmp_path, monkeypatch, capsys):
    def broken(config):
        raise FileNotFoundError("no split file")

    monkeypatch.setattr(tregistry, "build_dataset", broken)
    assert tcommon.prefit_full_set_features(_configs(tmp_path)[1], _Trainer()) is None
    assert ("[WARN] prefit_on_full_set failed (no split file); falling back to "
            "few-shot features.") in capsys.readouterr().out


def test_an_encode_error_propagates_where_jax_falls_back(tmp_path, capsys):
    import clip_gp_tpu.data.datasets  # noqa: F401  (registers Synthetic)
    import clip_gp_tpu_torch.data.datasets  # noqa: F401

    j_config, t_config = _configs(tmp_path)
    assert jcommon.prefit_full_set_features(j_config, _Trainer()) is None
    assert "illegal memory access" in capsys.readouterr().out  # JAX's [WARN]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tcommon.prefit_full_set_features(t_config, _Trainer())


@pytest.mark.parametrize("module,ported", [
    ("clip_gp_tpu_torch.models.clip_model", ("ModifiedResNet",)),
    ("clip_gp_tpu_torch.models.clip_loader", (".pt", "ResNet")),
    ("clip_gp_tpu_torch.methods", ("CLIP-Adapter", "TaskRes", "Tip-Adapter")),
    ("clip_gp_tpu_torch.methods.adapter", ("PREFIT_ON_FULL_SET",)),
])
def test_docstrings_name_what_is_ported(module, ported):
    import importlib

    doc = importlib.import_module(module).__doc__
    not_ported = doc.split("Not ported yet")[1] if "Not ported yet" in doc else ""
    for name in ported:
        assert name in doc, name
        assert name not in not_ported and "prefit" not in not_ported.lower(), name
