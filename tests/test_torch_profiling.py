"""The port's phase timers and trace hooks (``runtime/profiling.py``) against
the JAX package's.

The three cases of ``tests/test_profiling.py`` run on the port's module
(``maybe_trace`` writes a ``torch.profiler`` Chrome trace instead of a
``jax.profiler`` one, with a span's name on its timeline), then one CLI run per package on TEST-ViT (the
Adapter, 1 epoch) must time the same phases the same number of times:
``feature_extraction`` once per split extraction (test, then train) and
``train_epochs`` once.
"""

import json
import sys
import time
from pathlib import Path

import jax
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu.runtime import profiling as jax_profiling  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.runtime import profiling  # noqa: E402


def test_phase_timer_accumulates():
    profiling.reset_phases()
    with profiling.phase_timer("alpha"):
        time.sleep(0.01)
    with profiling.phase_timer("alpha"):
        time.sleep(0.01)
    with profiling.phase_timer("beta", device="cpu"):
        pass
    report = profiling.phase_report()
    assert report["alpha"]["count"] == 2
    assert report["alpha"]["total_s"] >= 0.02
    assert report["beta"]["count"] == 1
    profiling.reset_phases()
    assert profiling.phase_report() == {}


def test_maybe_trace_noop_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("x"):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())


def test_maybe_trace_writes_profile(monkeypatch, tmp_path):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_PROFILE_DIR", str(tmp_path))
    with profiling.maybe_trace("unit"), profiling.span("unit_range"):
        torch.ones(4).sum()
    traces = list((tmp_path / "unit").glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "unit_range" in names


def _argv(root, out, weights):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "2",
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights),
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "1",
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "100",
    ]


def test_trainer_times_the_jax_phases(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    weights = tmp_path / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))
    reports = {}
    for side, cli, reset, prof in (
            ("jax", jax_cli, jax_reset_tee, jax_profiling),
            ("port", port_cli, port_reset_tee, profiling)):
        prof.reset_phases()
        try:
            cli.main(_argv(tmp_path / f"data-{side}", tmp_path / side, weights))
        finally:
            reset()
        reports[side] = prof.phase_report()
    port, jax_report = reports["port"], reports["jax"]
    assert {k: v["count"] for k, v in port.items()} == {
        k: v["count"] for k, v in jax_report.items()}
    assert port["feature_extraction"]["count"] == 2
    assert port["train_epochs"]["count"] == 1
    for phase in ("feature_extraction", "train_epochs"):
        assert port[phase]["total_s"] > 0
