"""The port's sweep runner (``clip_gp_tpu_torch.parallel.sweep``) against the
JAX package's: the trial expansion (trials, signatures, outdirs, argv, the
unknown-key and merge warnings, skip-if-logged) and the vmap backend's
grouping on the experiment YAMLs of ``tests/test_sweep_and_aggregate.py``;
then the port alone: fallback counting and ``--strict-vmap``, CoCoOp's
routing (in-process by default, on the trial axis under ``--strict-vmap``
or ``CLIP_GP_TPU_TORCH_VMAP_COCOOP=1``) and a CoCoOp sweep on the trial
axis, the subprocess backend's ``--launcher`` prefix and GPU pinning,
and one small sweep end to end on the CPU (vmap, then in-process on one of
its trials: top-1 equal, metrics within 1e-3)."""

import json
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
for p in (REPO, TESTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import clip_gp_tpu.parallel.sweep as jsweep  # noqa: E402
import clip_gp_tpu.parallel.trial_vmap as jtv  # noqa: E402
import clip_gp_tpu_torch.parallel.sweep as tsweep  # noqa: E402
import clip_gp_tpu_torch.parallel.trial_vmap as ttv  # noqa: E402
from test_sweep_and_aggregate import _clip_adapter_sweep_cfg, _experiment_cfg  # noqa: E402


def _trainer_yaml(path, trainer, adapter_lines="", batch=8):
    path.write_text(textwrap.dedent(f"""\
        name: exp
        BASE_CONFIG: configs/trainers/default.yaml
        TRAINER_NAME: {trainer}
        MODEL:
          BACKBONE:
            NAME: TEST-ViT
        INPUT:
          SIZE: (32, 32)
          TRANSFORMS: []
        OPTIM:
          NAME: sgd
          LR: 0.05
        DATALOADER:
          NUM_WORKERS: 0
          TRAIN_X:
            BATCH_SIZE: {batch}
          TEST:
            BATCH_SIZE: 8
        TRAINER:
          ADAPTER:
            NUM_TEMPLATES: 2
            CLIP_ADAPTER_EPOCHS: 2
            N_CTX: 2
            USE_GP: False
    """) + textwrap.indent(textwrap.dedent(adapter_lines), " " * 4))
    return str(path)


def _sweep_cfg(tmp_path, trainer, grid, shots=(1, 2), seeds=(1, 2), name="exp",
               adapter_lines="", batch=8):
    return {
        "name": name,
        "datasets": ["synthetic"],
        "seeds": list(seeds),
        "shots": list(shots),
        "root": str(tmp_path / "data"),
        "output_root": str(tmp_path / "output"),
        "template": "{experiment}/{dataset}/{shots}shots{sig}/seed{seed}",
        "grid": grid,
        "dataset_config": "configs/datasets/synthetic.yaml",
        "__config_file__": _trainer_yaml(tmp_path / f"{name}.yaml", trainer,
                                         adapter_lines, batch),
    }


def _trial_view(t):
    return (t.index, t.dataset, t.seed, t.shots, t.signature(),
            str(t.format_outdir()), t.to_argv())


EXPANSIONS = {
    "gp-grid": lambda tmp: _experiment_cfg(tmp),
    "unknown-key": lambda tmp: {**_experiment_cfg(tmp), "opts": {"A": 1},
                                "TRAINER": {"NAME": "Adapter"}},
    "merge-warning": lambda tmp: {**_experiment_cfg(tmp), "seed": 7,
                                  "optim": {"LR": 0.5}},
    "clip-adapter": lambda tmp: _clip_adapter_sweep_cfg(tmp),
    "no-grid": lambda tmp: {"name": "plain", "datasets": "eurosat", "seeds": [3],
                            "output_root": str(tmp / "o")},
}


@pytest.mark.parametrize("case", list(EXPANSIONS))
def test_trial_expansion_matches_jax(tmp_path, capsys, case):
    cfg = EXPANSIONS[case](tmp_path)
    jtrials, jmeta = jsweep.build_trials(dict(cfg))
    jout = capsys.readouterr().out
    ttrials, tmeta = tsweep.build_trials(dict(cfg))
    tout = capsys.readouterr().out
    assert tout == jout
    assert tmeta == jmeta
    assert [_trial_view(t) for t in ttrials] == [_trial_view(t) for t in jtrials]
    assert tsweep.DATASET_NAME_MAP == jsweep.DATASET_NAME_MAP


def test_pending_trials_skips_logged_as_jax(tmp_path, capsys):
    cfg = _experiment_cfg(tmp_path)
    trials, _ = tsweep.build_trials(cfg)
    for t in trials[:3]:
        t.format_outdir().mkdir(parents=True, exist_ok=True)
        (t.format_outdir() / "log.txt").write_text("done")
    capsys.readouterr()
    jtodo = jsweep.pending_trials(jsweep.build_trials(cfg)[0])
    jout = capsys.readouterr().out
    ttodo = tsweep.pending_trials(trials)
    tout = capsys.readouterr().out
    assert tout == jout and tout.count("[SKIP] Existing log found") == 3
    assert [t.index for t in ttodo] == [t.index for t in jtodo]
    assert len(tsweep.pending_trials(trials, skip_logged=False)) == len(trials)


GROUPINGS = {
    # seeds x a ratio grid that joins the trial axis: one group per shots
    "vmappable-grid": ("CLIP-Adapter", {"TRAINER.ADAPTER.CLIP_ADAPTER_RATIO": [0.1, 0.5]}, ""),
    # a grid key off the trial axis splits the groups by signature
    "signature-split": ("TaskRes", {"TRAINER.ADAPTER.TASKRES_EPOCHS": [1, 2],
                                    "TRAINER.ADAPTER.TASKRES_LR": [0.01, 0.1]}, ""),
    "adapter-lr-gp": ("Adapter", {"OPTIM.LR": [0.01, 0.1],
                                  "TRAINER.ADAPTER.GP_BETA": [0.1, 1.0]},
                      "USE_GP: True\n"),
    # the uniform baseline trains nothing on the trial axis: in-process
    "uniform-baseline": ("Adapter", {}, "TRAIN_TEMPLATE_WEIGHTS: False\n"),
    "coop-lr": ("Adapter-CoOp", {"OPTIM.LR": [0.002, 0.02]}, ""),
    # under --strict-vmap CoCoOp trains on the trial axis in both packages
    "cocoop-lr": ("Adapter-CoCoOp", {"OPTIM.LR": [0.002, 0.02]}, ""),
}


def _record_groups(sweep_mod, tv_mod, monkeypatch, trials):
    groups, inproc = [], []

    def record(config, seeds, outdirs, trial_overrides=None, method=None, **kw):
        groups.append((method, list(seeds), [dict(o) for o in trial_overrides],
                       [str(d) for d in outdirs], int(config.dataset.num_shots)))
        return []

    monkeypatch.setattr(tv_mod, "run_vmapped_trials", record)
    monkeypatch.setattr(sweep_mod, "run_trials_inprocess",
                        lambda ts: inproc.extend(t.index for t in ts) or [])
    sweep_mod.run_trials_vmapped(trials, strict=True)
    return groups, sorted(inproc)


@pytest.mark.parametrize("case", list(GROUPINGS))
def test_vmap_grouping_matches_jax(tmp_path, monkeypatch, case):
    trainer, grid, adapter_lines = GROUPINGS[case]
    cfg = _sweep_cfg(tmp_path, trainer, grid, adapter_lines=adapter_lines)
    jgroups = _record_groups(jsweep, jtv, monkeypatch, jsweep.build_trials(cfg)[0])
    tgroups = _record_groups(tsweep, ttv, monkeypatch, tsweep.build_trials(cfg)[0])
    assert tgroups == jgroups
    assert tgroups[0] or tgroups[1]


def test_fallback_counting_and_strict_vmap(tmp_path, capsys, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("injected vmap failure")

    monkeypatch.setattr(ttv, "run_vmapped_trials", boom)
    cfg = _sweep_cfg(tmp_path, "CLIP-Adapter",
                     {"TRAINER.ADAPTER.CLIP_ADAPTER_RATIO": [0.1, 0.5]})
    trials, _ = tsweep.build_trials(cfg)
    with pytest.raises(RuntimeError, match="strict-vmap"):
        tsweep.run_trials_vmapped(trials, strict=True)
    ran = []
    monkeypatch.setattr(tsweep, "run_trials_inprocess", lambda ts: ran.extend(ts) or [])
    capsys.readouterr()
    tsweep.run_trials_vmapped(trials, strict=False)
    out = capsys.readouterr().out
    assert out.count("falling back to in-process") == 2
    assert "2 group(s) fell back" in out
    assert len(ran) == len(trials)


def test_cocoop_groups_route_inprocess_or_raise(tmp_path, capsys, monkeypatch):
    """The JAX runner's one-device routing (``tests/test_sweep_cocoop_routing.py``):
    a CoCoOp group runs in-process by default, and on the trial axis under
    ``strict`` or ``CLIP_GP_TPU_TORCH_VMAP_COCOOP=1`` (a spy on
    ``run_vmapped_trials`` records the group)."""
    cfg = _sweep_cfg(tmp_path, "Adapter-CoCoOp", {}, shots=(2,))
    trials, _ = tsweep.build_trials(cfg)
    ran, vmapped = [], []
    monkeypatch.setattr(tsweep, "run_trials_inprocess", lambda ts: ran.extend(ts) or [])

    def spy(config, seeds, outdirs, trial_overrides=None, method=None, **kwargs):
        vmapped.append((method, list(seeds)))
        return []

    monkeypatch.setattr(ttv, "run_vmapped_trials", spy)
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_VMAP_COCOOP", raising=False)
    tsweep.run_trials_vmapped(trials)
    out = capsys.readouterr().out
    assert "Adapter-CoCoOp routes to the in-process backend" in out
    assert len(ran) == 2 and vmapped == []
    for strict, env in ((True, None), (False, "1")):
        ran.clear()
        vmapped.clear()
        if env:
            monkeypatch.setenv("CLIP_GP_TPU_TORCH_VMAP_COCOOP", env)
        results = tsweep.run_trials_vmapped(trials, strict=strict)
        out = capsys.readouterr().out
        assert "routes to the in-process backend" not in out
        assert ran == [] and vmapped == [("Adapter-CoCoOp", [1, 2])]
        assert [r["backend"] for r in results] == ["vmap", "vmap"]
        assert out.count("[vmap] OK method=Adapter-CoCoOp") == 2


def test_cocoop_sweep_trains_on_the_trial_axis(tmp_path, monkeypatch):
    """``--backend vmap --strict-vmap`` on a CoCoOp experiment: one
    trial-batched group writes both trials' metrics.json, with the JAX
    runner's ``zero_shot: null``."""
    import yaml

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    cfg = _sweep_cfg(tmp_path, "Adapter-CoCoOp", {}, shots=(1,))
    # one YAML holds the experiment and, as uppercase keys, the trainer
    spec = yaml.safe_load(Path(cfg.pop("__config_file__")).read_text())
    spec.update(cfg)
    path = tmp_path / "cocoop_exp.yaml"
    path.write_text(yaml.safe_dump(spec))
    results = tsweep.main(["--config-file", str(path), "--backend", "vmap",
                           "--strict-vmap"])
    assert [r["backend"] for r in results] == ["vmap", "vmap"]
    for r in results:
        payload = json.loads((Path(r["out_dir"]) / "metrics.json").read_text())
        assert payload["method"] == "cocoop" and payload["zero_shot"] is None
        assert payload["metrics"]["top1_acc"] == payload["metrics"]["top1_acc"]


def test_multi_gpu_options_raise(tmp_path, capsys, monkeypatch, request):
    """``group_parallel`` and ``trial_mesh`` run on one device (the JAX
    scheduler's documented behaviour: workers may outnumber devices, and a
    trial mesh without a second device runs the group unsharded); only the
    two together raise, as in the JAX package."""
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    import torch

    # small CPU ops: one intra-op thread keeps them from oversubscribing a
    # host whose other cores run other test files
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    trials, _ = tsweep.build_trials(_sweep_cfg(tmp_path, "TaskRes", {}))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsweep.run_trials_vmapped(trials, group_parallel=2, trial_mesh=2)
    for name, kwargs, shots, line in (
            ("gp", {"group_parallel": 2}, (1, 2),
             "scheduling 2 trial group(s) over 2 worker(s) / 1 device(s)"),
            ("mesh", {"trial_mesh": 2}, (1,),
             "within the device budget; running unsharded")):
        trials, _ = tsweep.build_trials(_sweep_cfg(tmp_path, "TaskRes", {}, name=name,
                                                   shots=shots))
        results = tsweep.run_trials_vmapped(trials, **kwargs)
        out = capsys.readouterr().out
        assert line in out
        assert [r["backend"] for r in results] == ["vmap"] * len(trials)
        assert all((Path(r["out_dir"]) / "metrics.json").exists() for r in results)


@pytest.mark.parametrize("launcher", [None, "env CLIP_GP_TPU_HOST={device}"],
                         ids=["pinned", "launcher"])
def test_subprocess_backend_pins_and_prefixes(tmp_path, monkeypatch, launcher):
    calls = []

    def fake_call(cmd, env=None, **kwargs):
        calls.append((cmd, env))
        outdir = cmd[cmd.index("--output-dir") + 1]
        (Path(outdir) / "log.txt").write_text("ok")
        return 0

    monkeypatch.setattr(tsweep.subprocess, "call", fake_call)
    trials, _ = tsweep.build_trials(_clip_adapter_sweep_cfg(tmp_path))
    results = tsweep.run_trials_subprocess(trials, devices=["0", "1"], jobs_per_device=1,
                                           launcher=launcher)
    assert len(results) == len(trials) and all(r["return_code"] == 0 for r in results)
    child = [sys.executable, "-m", "clip_gp_tpu_torch.train"]
    argvs = {tuple(t.to_argv()) for t in trials}
    by_dev = {}
    for cmd, env in calls:
        dev = env["CUDA_VISIBLE_DEVICES"]
        by_dev[dev] = by_dev.get(dev, 0) + 1
        prefix = ["env", f"CLIP_GP_TPU_HOST={dev}"] if launcher else []
        assert cmd[:len(prefix) + 3] == prefix + child
        assert tuple(cmd[len(prefix) + 3:]) in argvs
        assert str(REPO) in env["PYTHONPATH"].split(":")
    assert by_dev == {"0": 2, "1": 2}  # round-robined over both GPUs


def test_sweep_end_to_end_on_cpu(tmp_path, capsys, monkeypatch):
    """A seeds × lr sweep of the Adapter through ``main`` on the vmap backend
    (one group), a rerun that skips every logged trial, the aggregator over
    the tree, and trial (seed 1, lr 0.05) again in-process through the
    wrapper: its top-1 equals the vmapped trial's, its metrics within 1e-3
    (one batch per epoch, so the in-process shuffle cannot differ)."""
    import yaml

    from clip_gp_tpu_torch.parallel import run_experiment
    from clip_gp_tpu_torch.reporting import aggregate

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    cfg = _sweep_cfg(tmp_path, "Adapter", {"OPTIM.LR": [0.05, 0.2]}, shots=(2,),
                     name="e2e", batch=16)
    trainer_yaml = cfg.pop("__config_file__")
    exp_yaml = tmp_path / "e2e_exp.yaml"
    exp_yaml.write_text(yaml.safe_dump({**yaml.safe_load(Path(trainer_yaml).read_text()),
                                        **cfg}))
    results = tsweep.main(["--config-file", str(exp_yaml), "--backend", "vmap",
                          "--strict-vmap"])
    out = capsys.readouterr().out
    assert [r["backend"] for r in results] == ["vmap"] * 4
    assert out.count("[vmap] OK method=Adapter") == 4
    runs = sorted((tmp_path / "output" / "e2e").glob("*/*/seed*/metrics.json"))
    assert len(runs) == 4
    tsweep.main(["--config-file", str(exp_yaml), "--backend", "vmap"])
    assert capsys.readouterr().out.count("[SKIP] Existing log found") == 4

    aggregate.main(["e2e", "--output-root", str(tmp_path / "output"), "--no-plots"])
    assert "=== Dataset: Synthetic ===" in capsys.readouterr().out
    assert (tmp_path / "output" / "e2e" / "_tables" / "Average.csv").exists()

    one = {**cfg, "seeds": [1], "grid": {"OPTIM.LR": [0.05]},
           "output_root": str(tmp_path / "inproc")}
    one_yaml = tmp_path / "one.yaml"
    one_yaml.write_text(yaml.safe_dump({**yaml.safe_load(Path(trainer_yaml).read_text()),
                                        **one}))
    assert run_experiment.main([str(one_yaml), "--backend", "inprocess"]) == 0
    [inproc_path] = (tmp_path / "inproc" / "e2e").glob("*/*/seed1/metrics.json")
    inproc = json.loads(inproc_path.read_text())["metrics"]
    vmapped = json.loads(next(p for p in runs if "LR0.05" in str(p)
                              and p.parent.name == "seed1").read_text())["metrics"]
    assert inproc["top1_acc"] == vmapped["top1_acc"]
    for key in ("ece", "aece", "macro_f1"):
        assert inproc[key] == pytest.approx(vmapped[key], abs=1e-3), key
