"""The port's parity harness and quick check
(``clip_gp_tpu_torch.scripts.parity_check`` / ``.quick_check``) against the
JAX package's ``scripts/parity_check.py`` / ``scripts/quick_check.py``.

- ``parity_trials`` for configs 1–5, with and without a backbone override,
  and ``diff_metrics`` on within-, over- and missing-key pairs equal the
  JAX functions' results;
- ``--convert`` of a random OpenAI-layout state dict (TEST-RN, TEST-ViT),
  saved with ``torch.save``, writes an npz equal to the JAX script's key for
  key and bit for bit;
- config 1 with ``--backbone-override TEST-ViT`` on the Caltech101 fixture
  (as ``tests/test_parity_harness.py`` runs it), both packages loading one
  npz of weights: the same exit code and status line per trial (NO-REF
  without a reference, OK against one), top-1 equal, ECE and AECE within
  5e-3;
- the quick check's ``METHODS`` table equals the JAX one, and its ``main``
  prints eight OK lines and returns 0 at one epoch.
"""

import json

import jax
import numpy as np
import pytest
import torch

import scripts.parity_check as jax_pc
import scripts.quick_check as jax_qc
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz
from clip_gp_tpu.models.clip_model import ARCHITECTURES
from clip_gp_tpu_torch.scripts import parity_check as port_pc
from clip_gp_tpu_torch.scripts import quick_check as port_qc
from tests.test_dataset_catalogs import build_caltech101
from tests.test_torch_convert import openai_state_dict

TRIAL = "caltech101_4shot_rn50_baseline"
METRIC_TOL = 5e-3
CONFIG1_OPTS = [
    "INPUT.SIZE", "(32, 32)",
    "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "2",
    "TRAINER.ADAPTER.NUM_TEMPLATES", "2",
    "DATALOADER.NUM_WORKERS", "2",
    "DATALOADER.BATCH_SIZE_TRAIN", "4",
    "DATALOADER.BATCH_SIZE_TEST", "4",
]


@pytest.mark.parametrize("override", [None, "TEST-ViT"])
@pytest.mark.parametrize("config_id", [1, 2, 3, 4, 5])
def test_parity_trials_equal_jax(config_id, override):
    assert (port_pc.parity_trials(config_id, override)
            == jax_pc.parity_trials(config_id, override))


@pytest.mark.parametrize("ref", [
    {"metrics": {"top1_acc": 90.25, "ece": 4.3, "aece": 3.0}},   # within (0.3 exact)
    {"metrics": {"top1_acc": 90.0, "ece": 4.35, "aece": 2.0}},   # over
    {"metrics": {"top1_acc": 90.0}},                              # missing keys
], ids=["within", "over", "missing"])
def test_diff_metrics_equal_jax(ref):
    run = {"metrics": {"top1_acc": 90.0, "ece": 4.0, "aece": 3.0}}
    assert port_pc.diff_metrics(run, ref) == jax_pc.diff_metrics(run, ref)
    assert port_pc.diff_metrics(run, ref, 0.05) == jax_pc.diff_metrics(run, ref, 0.05)


@pytest.mark.parametrize("backbone", ["TEST-RN", "TEST-ViT"])
def test_convert_npz_bit_equal_jax(backbone, tmp_path):
    pt = tmp_path / "clip.pt"
    torch.save(openai_state_dict(ARCHITECTURES[backbone], seed=3), pt)
    assert jax_pc.main(["--convert", str(pt), "--weights-out",
                        str(tmp_path / "jax.npz")]) == 0
    assert port_pc.main(["--convert", str(pt), "--weights-out",
                         str(tmp_path / "port.npz")]) == 0
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _status_lines(out):
    return [line for line in out.splitlines()
            if line.startswith(("[NO-REF] ", "[OK] ", "[FAIL] "))]


def test_config1_equal_jax(tmp_path, capfd, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    build_caltech101(tmp_path)
    weights = tmp_path / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))

    def both(reference_root=None):
        runs = {}
        for name, mod in (("jax", jax_pc), ("port", port_pc)):
            argv = ["--config", "1", "--root", str(tmp_path),
                    "--output-root", str(tmp_path / name),
                    "--backbone-override", "TEST-ViT"]
            if reference_root is not None:
                argv += ["--reference-root", str(reference_root)]
            rc = mod.main(argv + CONFIG1_OPTS + ["MODEL.INIT_WEIGHTS", str(weights)])
            metrics = json.loads((tmp_path / name / TRIAL / "metrics.json")
                                 .read_text())["metrics"]
            runs[name] = (rc, _status_lines(capfd.readouterr().out), metrics)
        return runs

    def check(runs, status):
        (rc_j, lines_j, m_j), (rc_p, lines_p, m_p) = runs["jax"], runs["port"]
        assert rc_p == rc_j == 0
        assert lines_p == lines_j == [f"[{status}] {TRIAL}"]
        assert m_p["top1_acc"] == m_j["top1_acc"]
        for key in ("ece", "aece"):
            assert abs(m_p[key] - m_j[key]) <= METRIC_TOL, key
        return m_j

    m_jax = check(both(), "NO-REF")
    ref_dir = tmp_path / "refruns" / TRIAL
    ref_dir.mkdir(parents=True)
    (ref_dir / "metrics.json").write_text(json.dumps({"metrics": {
        "top1_acc": m_jax["top1_acc"] + 0.2, "ece": m_jax["ece"] - 0.1,
        "aece": m_jax["aece"]}}))
    check(both(tmp_path / "refruns"), "OK")


def test_quick_check_methods_equal_jax():
    assert port_qc.METHODS == jax_qc.METHODS


def test_quick_check_main_eight_ok(capsys, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    assert port_qc.main(["--epochs", "1"]) == 0
    out = capsys.readouterr().out
    summary = out.split("===== summary =====")[1].splitlines()
    ok = [line.split() for line in summary if line.strip() and not line.startswith("{")]
    assert ok == [[label, "OK"] for label, _, _ in jax_qc.METHODS]
    report = json.loads(out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and all(report["results"].values())
