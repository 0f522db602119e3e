"""The port's multi-device sweep placement against the JAX package's, with
two CPU slots standing in for two devices (``core.device.local_devices``
replaced; the JAX side runs on the suite's virtual CPU devices):

- ``_group_trial_mesh`` against the JAX function over a table of
  (trials, requested, devices);
- the CLI's ``--trial-mesh`` errors and the mutual exclusion with
  ``--group-parallel``, message for message;
- ``--group-parallel 2`` over two dataset keys of one Synthetic tree: every
  metrics.json field but the wall clock equals the sequential run's, and
  top-1 equals the JAX ``run_trials_vmapped(group_parallel=2)`` (ECE, AECE
  and macro-F1 within 5e-3, as ``tests/test_torch_sweep.py``);
- ``--trial-mesh 2`` through the CLI against the sequential run, and a T=4
  Adapter+GP group on a trial mesh of 2 (fed the JAX runner's draws) against
  the unsharded port run (top-1 equal, metrics within 1e-3) and against the
  JAX runner with ``mesh`` (top-1 equal);
- CoCoOp kept on the trial axis under a parallel schedule and a usable trial
  mesh (a spy on ``run_vmapped_trials``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
for p in (REPO, TESTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import clip_gp_tpu.parallel.sweep as jsweep  # noqa: E402
import clip_gp_tpu.parallel.trial_vmap as jtv  # noqa: E402
import clip_gp_tpu_torch.parallel.sweep as tsweep  # noqa: E402
import clip_gp_tpu_torch.parallel.trial_vmap as ttv  # noqa: E402
from clip_gp_tpu_torch.core import device as device_mod  # noqa: E402
from test_torch_sweep import _sweep_cfg  # noqa: E402

CPU2 = [torch.device("cpu"), torch.device("cpu")]
ECE_TOL = 5e-3
MESH_TOL = 1e-3
WALL_CLOCK = ("timestamp", "train_time_s")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The sweeps here run many small CPU ops; one intra-op thread keeps
    them from oversubscribing a host whose other cores run other test
    files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def two_slots(monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    monkeypatch.setattr(device_mod, "local_devices", lambda: list(CPU2))
    return CPU2


def _jax_devices(n):
    import jax

    devices = jax.devices()
    if len(devices) < n:
        pytest.skip(f"needs {n} JAX devices (the suite's virtual CPU devices)")
    return devices[:n]


def test_group_trial_mesh_matches_jax():
    devices = _jax_devices(8)
    for t in (1, 2, 3, 4, 5, 6, 8, 12):
        for requested in (2, 3, 4, 8, 1 << 30):
            for n_dev in (1, 2, 3, 4, 8):
                want = jsweep._group_trial_mesh(t, devices[:n_dev], requested)
                got = tsweep._group_trial_mesh(t, list(range(n_dev)), requested)
                assert (None if want is None else int(want.devices.size)) == (
                    None if got is None else len(got)), (t, requested, n_dev)
                assert got is None or got == list(range(len(got)))


def test_cli_errors_and_mutual_exclusion_match_jax(capsys):
    for args in (["--trial-mesh", "1", "--backend", "vmap"],
                 ["--trial-mesh", "two", "--backend", "vmap"],
                 ["--trial-mesh", "2"]):
        errs = []
        for mod in (jsweep, tsweep):
            with pytest.raises(SystemExit) as e:
                mod.main(["--config-file", "unused.yaml", *args])
            assert e.value.code == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]
    msgs = []
    for mod in (jsweep, tsweep):
        with pytest.raises(ValueError, match="mutually exclusive") as e:
            mod.run_trials_vmapped([], group_parallel=2, trial_mesh=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params, save_params_npz
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    path = tmp_path_factory.mktemp("weights") / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(path), arch, init_clip_params(arch, seed=0, device="cpu"))
    return path


def _two_dataset_yaml(tmp_path, weights, name, output_root):
    """An experiment YAML over two dataset keys that name one Synthetic tree
    (the scheduler's buckets are per dataset key), TaskRes without GP (no
    noise), seeds 1 and 2 at 2 shots: two groups of T=2."""
    cfg = _sweep_cfg(tmp_path, "TaskRes", {}, shots=(2,), name=name)
    spec = yaml.safe_load(Path(cfg.pop("__config_file__")).read_text())
    spec["MODEL"]["INIT_WEIGHTS"] = str(weights)
    cfg.update(datasets=["synthetic", "Synthetic"], output_root=str(output_root))
    path = tmp_path / f"{name}_exp.yaml"
    path.write_text(yaml.safe_dump({**spec, **cfg}))
    return path


def _metrics_jsons(root):
    return {str(p.relative_to(root)): json.loads(p.read_text())
            for p in sorted(Path(root).glob("**/metrics.json"))}


def test_group_parallel_and_trial_mesh_equal_the_sequential_sweep_and_jax(
        tmp_path, weights, two_slots, capsys):
    path = _two_dataset_yaml(tmp_path, weights, "gp", tmp_path / "port")
    argv = ["--config-file", str(path), "--backend", "vmap", "--strict-vmap",
            "--no-skip-logged"]
    tsweep.main(argv + ["--group-parallel", "1"])
    seq = _metrics_jsons(tmp_path / "port")
    assert len(seq) == 4
    capsys.readouterr()
    runs = {}
    for flags, line in ((["--group-parallel", "2"],
                         "scheduling 2 trial group(s) over 2 worker(s) / 2 device(s)"),
                        (["--trial-mesh", "2"], "shards 2 trial(s) over 2 device(s)")):
        results = tsweep.main(argv + flags)
        assert line in capsys.readouterr().out
        assert [r["backend"] for r in results] == ["vmap"] * 4
        runs[flags[0]] = _metrics_jsons(tmp_path / "port")
    for rel, want in seq.items():
        for key in set(want) - set(WALL_CLOCK):
            assert runs["--group-parallel"][rel][key] == want[key], (rel, key)
        got = runs["--trial-mesh"][rel]["metrics"]
        assert got["top1_acc"] == want["metrics"]["top1_acc"], rel
        for key in ("ece", "aece", "macro_f1"):
            assert got[key] == pytest.approx(want["metrics"][key], abs=MESH_TOL), key

    _jax_devices(2)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setenv("CLIP_GP_TPU_FORCE_CPU", "1")
    try:
        jpath = _two_dataset_yaml(tmp_path, weights, "gp", tmp_path / "jax")
        cfg = yaml.safe_load(jpath.read_text())
        cfg["__config_file__"] = str(jpath)
        jtrials, _ = jsweep.build_trials(cfg)
        jsweep.run_trials_vmapped(jtrials, strict=True, group_parallel=2)
    finally:
        monkeypatch.undo()
    jax_runs = _metrics_jsons(tmp_path / "jax")
    assert set(jax_runs) == set(seq)
    for rel, want in jax_runs.items():
        got = runs["--group-parallel"][rel]["metrics"]
        assert got["top1_acc"] == want["metrics"]["top1_acc"], rel
        for key in ("ece", "aece", "macro_f1"):
            assert got[key] == pytest.approx(want["metrics"][key], abs=ECE_TOL), key


def test_gp_group_on_a_trial_mesh_matches_unsharded_and_jax(tmp_path, weights):
    from jax.sharding import Mesh

    from clip_gp_tpu.core.config import Config as JConfig
    from clip_gp_tpu.runtime import feature_cache as jcache
    from clip_gp_tpu_torch.core.config import Config as TConfig
    from clip_gp_tpu_torch.runtime import feature_cache as tcache
    from test_torch_trial_vmap import N_CLASSES, make_config
    from test_torch_trial_vmap_gp import jax_draws

    seeds = [1, 2, 3, 4]
    jcfg = make_config(JConfig, tmp_path / "data-jax", weights, "Adapter", use_gp=True)
    jcache.memo_clear()
    jres = jtv.run_vmapped_trials(jcfg, seeds, method="Adapter",
                                  mesh=Mesh(np.array(_jax_devices(2)), ("trial",)))
    out = {}
    for name, mesh in (("unsharded", None), ("mesh", CPU2)):
        cfg = make_config(TConfig, tmp_path / "data-port", weights, "Adapter",
                          use_gp=True)
        n_batches = len(range(0, 2 * N_CLASSES, cfg.dataloader.batch_size_train))
        draws = jax_draws(seeds, n_batches=n_batches, epochs=3,
                          prestage_epochs=int(cfg.optim.max_epoch))
        tcache.memo_clear()
        out[name] = ttv.run_vmapped_trials(cfg, seeds, method="Adapter", device="cpu",
                                           draws=draws, mesh=mesh)
    for t in range(len(seeds)):
        want, got = out["unsharded"][t]["metrics"], out["mesh"][t]["metrics"]
        assert got["top1_acc"] == want["top1_acc"] == jres[t]["metrics"]["top1_acc"], t
        for key in ("ece", "aece", "macro_f1"):
            assert got[key] == pytest.approx(want[key], abs=MESH_TOL), (t, key)


def test_cocoop_stays_on_the_trial_axis_on_a_parallel_schedule(
        tmp_path, two_slots, capsys, monkeypatch):
    """The JAX routing's multi-device half: with two devices and two
    datasets (the default schedule), ``--group-parallel 2``, or a usable
    trial mesh, CoCoOp groups train on the trial axis; a trial mesh with one
    device left routes them in-process. Parallel workers run pinned to
    device w mod 2."""
    cfg = _sweep_cfg(tmp_path, "Adapter-CoCoOp", {}, shots=(2,))
    two_shots = {**cfg, "shots": [1, 2]}
    ran, vmapped = [], []
    monkeypatch.setattr(tsweep, "run_trials_inprocess", lambda ts: ran.extend(ts) or [])
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_VMAP_COCOOP", raising=False)

    def spy(config, seeds, outdirs, trial_overrides=None, method=None, mesh=None,
            **kwargs):
        vmapped.append((method, list(seeds), None if mesh is None else len(mesh),
                        device_mod.pinned()))
        return []

    monkeypatch.setattr(ttv, "run_vmapped_trials", spy)
    two_datasets = {**cfg, "datasets": ["synthetic", "Synthetic"]}
    for case, kwargs in ((two_datasets, {}), (two_shots, {"group_parallel": 2}),
                         (cfg, {"trial_mesh": 2})):
        ran.clear()
        vmapped.clear()
        trials, _ = tsweep.build_trials(dict(case))
        tsweep.run_trials_vmapped(trials, **kwargs)
        assert "routes to the in-process backend" not in capsys.readouterr().out
        assert ran == [] and vmapped and all(v[0] == "Adapter-CoCoOp" for v in vmapped)
        if "trial_mesh" in kwargs:
            assert vmapped == [("Adapter-CoCoOp", [1, 2], 2, None)]
        else:
            # two groups, each on a worker pinned to a device
            assert sorted(v[1] for v in vmapped) == [[1, 2], [1, 2]]
            assert all(v[3] == torch.device("cpu") for v in vmapped)
    monkeypatch.setattr(device_mod, "local_devices", lambda: [torch.device("cpu")])
    ran.clear()
    vmapped.clear()
    trials, _ = tsweep.build_trials(dict(cfg))
    tsweep.run_trials_vmapped(trials, trial_mesh=2)
    assert "routes to the in-process backend" in capsys.readouterr().out
    assert len(ran) == 2 and vmapped == []
