"""Grid experiment runner (ref: utils/hparam_search.py), the port of the JAX
package's ``parallel/sweep.py``.

Same experiment-YAML contract: ``datasets``/``seeds``/``shots``/``grid``
Cartesian expansion, human-readable trial signatures, ``template`` output-dir
formatting, skip-if-``log.txt``-exists resumability, OK/FAIL progress lines.
The trial expansion (``DATASET_NAME_MAP``, ``Trial``, ``build_trials``,
``pending_trials``) is a copy of the JAX package's.

Execution backends:
- ``inprocess`` (default): trials run one after another inside this
  process through ``clip_gp_tpu_torch.train.main``; each trial's stdout is
  teed into its ``log.txt``.
- ``subprocess``: one ``python -m clip_gp_tpu_torch.train`` child per
  trial, a worker pool of ``--jobs-per-device`` × devices. Without a
  ``--launcher`` each child is pinned to one GPU with
  ``CUDA_VISIBLE_DEVICES=<id>`` (the reference's pinning; the JAX package
  pins with its own env var).
- ``vmap``: trials that differ only by seed or by grid values that join the
  trial axis train as one trial-batched program per group
  (``trial_vmap.py``), group after group, each next group's splits and
  train-union decode started on a host thread while a feature-cached group
  trains (decode-ahead; ``CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH=1``
  turns it off, ``CLIP_GP_TPU_TORCH_PREFETCH_BUDGET_MB`` bounds its buffer);
  the rest run in-process.

Run as ``python -m clip_gp_tpu_torch.parallel.sweep --config-file exp.yaml
[--backend inprocess|subprocess|vmap]``, or through
``python -m clip_gp_tpu_torch.parallel.run_experiment exp.yaml [args]``.
The in-process and vmap backends run on the GPU, or on the CPU with
``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` (``core.device.resolve_device``); the
subprocess children resolve their own device the same way.

Not here yet (ROADMAP queue 1): ``--group-parallel`` (groups pinned to
several GPUs) and ``--trial-mesh`` (one group's trial axis over several
GPUs) raise; the sharded extraction the JAX package switches off during a
sweep does not exist in the port.
"""

from __future__ import annotations

import argparse
import itertools
import os
import queue
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

# the ROADMAP item that brings what this module refuses
MULTI_GPU_ITEM = "ROADMAP queue 1, item 2 (multi-GPU placement)"

DATASET_NAME_MAP = {
    "caltech101": "Caltech101",
    "oxford_pets": "OxfordPets",
    "oxford_flowers": "OxfordFlowers",
    "fgvc_aircraft": "FGVCAircraft",
    "dtd": "DescribableTextures",
    "eurosat": "EuroSAT",
    "stanford_cars": "StanfordCars",
    "food101": "Food101",
    "sun397": "SUN397",
    "ucf101": "UCF101",
    "imagenet": "ImageNet",
    "imagenet_sketch": "ImageNetSketch",
    "imagenetv2": "ImageNetV2",
    "imagenet_a": "ImageNetA",
    "imagenet_r": "ImageNetR",
    "synthetic": "Synthetic",
}


@dataclass
class Trial:
    index: int
    dataset: str
    seed: int
    shots: int
    dataset_cfg: str
    output_root: Path
    output_template: str
    grid_overrides: Dict[str, Any]
    root_override: Optional[str]
    experiment_name: str
    config_file: str
    extra_env: Dict[str, str] = field(default_factory=dict)

    def signature(self) -> str:
        if not self.grid_overrides:
            return ""
        return "_".join(
            f"{k.split('.')[-1]}{v}" for k, v in sorted(self.grid_overrides.items())
        )

    def format_outdir(self) -> Path:
        placeholders = {
            "sweep": self.experiment_name,
            "experiment": self.experiment_name,
            "dataset": self.dataset,
            "shots": self.shots,
            "seed": self.seed,
            "sig": self.signature(),
        }
        placeholders.update(self.grid_overrides)
        return (self.output_root / self.output_template.format(**placeholders)).resolve()

    def to_argv(self) -> List[str]:
        out_dir = self.format_outdir()
        out_dir.mkdir(parents=True, exist_ok=True)
        argv = [
            "--dataset-config-file", self.dataset_cfg,
            "--config-file", self.config_file,
            "--dataset", DATASET_NAME_MAP.get(self.dataset.lower(), self.dataset),
            "--seed", str(self.seed),
            "--output-dir", str(out_dir),
        ]
        if self.root_override:
            argv += ["--root", self.root_override]
        for k, v in sorted(self.grid_overrides.items()):
            argv += [k, str(v)]
        argv += ["DATASET.NUM_SHOTS", str(self.shots)]
        return argv


# Top-level keys the experiment YAML contract defines (ref:
# utils/hparam_search.py:146-160). The same YAML is also passed to the
# trainer as --config-file, so merge_config_dict (core/config.py) consumes
# two more classes of key in EVERY trial: uppercase keys (embedded trainer
# config) and lowercase keys naming a config section (optim:, dataset:, ...)
# or a top-level Config field (seed:, resume:, ...). Only keys in none of
# those classes are truly ignored — warn so a typoed `opts:` doesn't silently
# run the wrong experiment, and flag section/field names that merge as
# trainer config since that is rarely what a sweep author intended here.
_EXPERIMENT_KEYS = {
    "name", "datasets", "seeds", "shots", "dataset_config", "output_root",
    "grid", "template", "root", "devices", "__config_file__",
}


def _trainer_config_keys() -> set:
    """Lowercase keys merge_config_dict consumes as trainer config."""
    import dataclasses as _dc

    from clip_gp_tpu_torch.core import config as _config_mod

    fields = {f.name for f in _dc.fields(_config_mod.Config)}
    return set(_config_mod._SECTIONS) | fields


def build_trials(cfg: Dict[str, Any]) -> Tuple[List[Trial], Dict[str, Any]]:
    trainer_keys = _trainer_config_keys()
    for key in cfg:
        if key in _EXPERIMENT_KEYS or key[:1].isupper():
            continue
        if key.lower() in trainer_keys:
            print(
                f"[WARN] experiment key {key!r} merges as trainer config in "
                "every trial (it names a config section or field; move it "
                "under an uppercase section or remove it if unintended)"
            )
        else:
            print(
                f"[WARN] unknown experiment key {key!r} ignored (known keys: "
                f"{sorted(_EXPERIMENT_KEYS - {'__config_file__'})}; uppercase "
                "keys merge as embedded trainer config)"
            )
    name = cfg.get("name") or "experiment"
    datasets = cfg.get("datasets")
    if isinstance(datasets, str):
        datasets = [datasets]
    seeds = list(cfg.get("seeds", [1]))
    shots = list(cfg.get("shots", [1]))
    output_root = Path(cfg.get("output_root", "output"))
    grid: Dict[str, Any] = cfg.get("grid") or {}
    template = cfg.get("template", "{experiment}/{dataset}/{sig}/seed{seed}")
    keys = list(grid.keys())
    values = [grid[k] if isinstance(grid[k], list) else [grid[k]] for k in keys]
    trials: List[Trial] = []
    for ds in datasets:
        dataset_cfg = cfg.get("dataset_config") or f"configs/datasets/{ds}.yaml"
        for seed in seeds:
            for nshot in shots:
                for combo in itertools.product(*values) if keys else [()]:
                    trials.append(
                        Trial(
                            index=len(trials),
                            dataset=ds,
                            seed=int(seed),
                            shots=int(nshot),
                            dataset_cfg=dataset_cfg,
                            output_root=output_root,
                            output_template=template,
                            grid_overrides=dict(zip(keys, combo)),
                            root_override=cfg.get("root"),
                            experiment_name=name,
                            config_file=str(cfg.get("__config_file__", "")),
                        )
                    )
    return trials, {"experiment_name": name, "n_trials": len(trials)}


def pending_trials(trials: List[Trial], skip_logged: bool = True) -> List[Trial]:
    out = []
    for t in trials:
        if skip_logged and (t.format_outdir() / "log.txt").exists():
            print(
                f"[SKIP] Existing log found, skipping: dataset={t.dataset} "
                f"shots={t.shots} seed={t.seed} sig={t.signature()}"
            )
            continue
        out.append(t)
    return out


def _result(trial: Trial, rc: int, backend: str) -> Dict[str, Any]:
    return {
        "index": trial.index,
        "dataset": trial.dataset,
        "seed": trial.seed,
        "shots": trial.shots,
        "sig": trial.signature(),
        "out_dir": str(trial.format_outdir()),
        "return_code": rc,
        "backend": backend,
    }


def run_trials_inprocess(trials: List[Trial]) -> List[Dict[str, Any]]:
    """Sequential in-process execution: the CLIP weights are loaded by each
    trial, and each trial's stdout is teed into its log.txt."""
    from clip_gp_tpu_torch import train as train_main
    from clip_gp_tpu_torch.core.logging import reset_tee

    results = []
    total = len(trials)
    for i, trial in enumerate(trials):
        rc = 0
        try:
            train_main.main(trial.to_argv())
        except Exception as e:  # a failed trial must not kill the sweep
            import traceback

            traceback.print_exc()
            print(f"[ERROR] trial failed: {e}")
            rc = 1
        finally:
            reset_tee()
        status = "OK" if rc == 0 else "FAIL"
        print(
            f"[{i + 1}/{total}] {status} dataset={trial.dataset} "
            f"shots={trial.shots} seed={trial.seed} config={trial.signature()}"
        )
        results.append(_result(trial, rc, "inprocess"))
    return results


def _vmap_supported(config, group_size: int) -> bool:
    """Can this trial group train as one trial-batched program? The JAX
    package's gate, unchanged: every trainable head qualifies (Adapter,
    CLIP-Adapter, TaskRes, Tip-Adapter-F, CoOp, CoCoOp), including the GP /
    template-weight pre-stage variants. CoCoOp passes the gate and is then
    routed by ``run_trials_vmapped``."""
    a = config.adapter
    name = str(config.trainer_name)
    if group_size < 2:
        return False
    if name == "Adapter":
        # any trainable head (GP / per-class logits / linear [D,1] head),
        # incl. freeze_visual_proj and shared_template_weights; only the
        # non-trainable uniform baseline stays in-process
        return bool(
            a.use_gp
            or a.train_template_weights
            or a.use_linear_template_weighting
        )
    if name in ("CLIP-Adapter", "TaskRes"):
        return True
    if name == "Tip-Adapter":
        return bool(a.tip_adapter_trainable)  # only the trainable -F variant
    if name in ("Adapter-CoOp", "Adapter-CoCoOp"):
        return True
    return False


def _trial_config(t: Trial):
    """The trainer config one trial of the group runs with."""
    from clip_gp_tpu_torch.core.config import (
        Config,
        merge_config_from_file,
        merge_from_opts,
    )

    config = Config()
    merge_config_from_file(config, t.dataset_cfg)
    merge_config_from_file(config, t.config_file)
    for k, v in sorted(t.grid_overrides.items()):
        merge_from_opts(config, [k, str(v)])
    config.dataset.num_shots = t.shots
    config.dataset.name = DATASET_NAME_MAP.get(t.dataset.lower(), t.dataset)
    if t.root_override:
        config.dataset.root = t.root_override
    return config


def group_trials(trials: List[Trial]) -> Tuple[Dict[tuple, List[Trial]], Dict[tuple, Any]]:
    """The vmap backend's grouping, the JAX package's: trials sharing
    (dataset, shots, method) form one group when every grid key they vary
    joins the trial axis (``trial_vmap.vmappable_config_keys``), else the
    grid signature splits them."""
    from clip_gp_tpu_torch.parallel.trial_vmap import vmappable_config_keys

    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401

    vmappable_keys = vmappable_config_keys()
    groups: Dict[tuple, List[Trial]] = {}
    configs: Dict[tuple, Any] = {}
    for t in trials:
        config = _trial_config(t)
        vmappable = vmappable_keys.get(str(config.trainer_name), {})
        if all(k in vmappable for k in t.grid_overrides):
            # seeds AND scalar grid cells share one trial-batched program
            key = (t.dataset, t.shots, str(config.trainer_name))
        else:
            key = (t.dataset, t.shots, str(config.trainer_name), t.signature())
        groups.setdefault(key, []).append(t)
        configs.setdefault(key, config)
    return groups, configs


def run_trials_vmapped(
    trials: List[Trial], strict: bool = False,
    group_parallel: Optional[int] = None,
    trial_mesh: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Group trials that differ only by seed (or by grid values that join the
    trial axis) and train each group as one trial-batched program on one
    device, group after group. Trials the gate does not admit run
    in-process. A group that fails falls back to the in-process backend
    with a counted ``[vmap] ... fallback`` line (the JAX package's
    behaviour); with ``strict`` it raises instead.

    CoCoOp groups take the in-process backend, the JAX runner's default on
    one device; ``strict`` or ``CLIP_GP_TPU_TORCH_VMAP_COCOOP=1`` trains
    them on the trial axis.

    Decode-ahead: when a feature-cached group reaches training
    (``on_before_train``), a ``DecodePrefetcher`` samples the next group's
    splits and decodes its train union on a host thread, and the next group
    adopts it. ``CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH=1`` runs the
    groups strictly one after another; the draws are the same either way.

    ``group_parallel`` > 1 and ``trial_mesh`` (several GPUs) raise: they
    are ``MULTI_GPU_ITEM``."""
    if trial_mesh or (group_parallel or 1) > 1:
        raise NotImplementedError(
            "--group-parallel > 1 and --trial-mesh spread groups over several "
            f"GPUs, which the port does not do yet ({MULTI_GPU_ITEM})"
        )
    from clip_gp_tpu_torch.parallel.trial_vmap import (
        DecodePrefetcher,
        run_vmapped_trials,
        vmappable_config_keys,
    )

    vmappable_keys = vmappable_config_keys()
    groups, configs = group_trials(trials)

    results: List[Dict[str, Any]] = []
    leftovers: List[Trial] = []
    n_fallback_groups = 0
    force_cocoop = os.environ.get("CLIP_GP_TPU_TORCH_VMAP_COCOOP") == "1"

    work_items: List[Tuple] = []
    for key, group in groups.items():
        config = configs[key]
        method = str(config.trainer_name)
        if not _vmap_supported(config, len(group)):
            # head variants the trial-batched runner doesn't model
            leftovers.extend(group)
            continue
        if method == "Adapter-CoCoOp" and not strict and not force_cocoop:
            print(
                f"[vmap] group {key}: Adapter-CoCoOp routes to the in-process "
                "backend on one device (the JAX runner's default); "
                "--strict-vmap or CLIP_GP_TPU_TORCH_VMAP_COCOOP=1 trains it on "
                "the trial axis"
            )
            leftovers.extend(group)
            continue
        vmappable = vmappable_keys[method]
        seeds = [t.seed for t in group]
        overrides = [
            {vmappable[k]: v for k, v in t.grid_overrides.items() if k in vmappable}
            for t in group
        ]
        outdirs = [t.format_outdir() for t in group]
        for d in outdirs:
            d.mkdir(parents=True, exist_ok=True)
        work_items.append((key, group, config, method, seeds, overrides, outdirs))

    prefetch_on = (os.environ.get("CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH") != "1"
                   and len(work_items) > 1)
    prefetchers: List[Any] = [None] * len(work_items)

    def _starter(i: int):
        def start() -> None:
            j = i + 1
            if not prefetch_on or j >= len(work_items) or prefetchers[j] is not None:
                return
            key_j, _, config_j, method_j, seeds_j, overrides_j, _ = work_items[j]
            try:
                prefetchers[j] = DecodePrefetcher(config_j, seeds_j,
                                                  trial_overrides=overrides_j,
                                                  method=method_j).start()
            except Exception as e:
                # the group's own run meets the same error and reports it
                print(f"[vmap] decode-ahead: group {key_j} not prefetched ({e})")
                return
            print(f"[vmap] decode-ahead: prefetching group {j + 1}/{len(work_items)}")

        return start

    for i, (key, group, config, method, seeds, overrides, outdirs) in enumerate(
            work_items):
        prefetched = prefetchers[i]
        try:
            if prefetched is not None:
                # adopt the decode-ahead runner: its splits are sampled and
                # its union decode is under way or done
                prefetched.runner.on_before_train = _starter(i)
                prefetched.runner.run(outdirs)
            else:
                run_vmapped_trials(
                    config, seeds, outdirs, trial_overrides=overrides, method=method,
                    on_before_train=_starter(i),
                )
        except Exception as e:
            import traceback

            if prefetched is not None:
                prefetched.cancel()
            traceback.print_exc()
            if strict:
                for pf in prefetchers:
                    if pf is not None and not pf.consumed:
                        pf.cancel()
                raise RuntimeError(
                    f"vmapped group {key} failed under --strict-vmap"
                ) from e
            n_fallback_groups += 1
            print(
                f"[ERROR] vmapped group {key} failed ({e}); "
                "falling back to in-process (use --strict-vmap to error)"
            )
            leftovers.extend(group)
            continue
        for t in group:
            (t.format_outdir() / "log.txt").touch()  # skip-if-done
            results.append(_result(t, 0, "vmap"))
            print(
                f"[vmap] OK method={method} dataset={t.dataset} "
                f"shots={t.shots} seed={t.seed} config={t.signature()}"
            )

    if n_fallback_groups:
        print(
            f"[vmap] WARNING: {n_fallback_groups} group(s) fell back to the "
            "in-process backend after vmapped failures"
        )
    if leftovers:
        print(
            f"[vmap] {len(leftovers)} trial(s) not vmap-groupable; "
            "running in-process"
        )
        results.extend(run_trials_inprocess(leftovers))
    return results


def run_trials_subprocess(
    trials: List[Trial],
    devices: List[str],
    jobs_per_device: int,
    verbose: bool = False,
    launcher: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Reference-style process-per-trial worker pool
    (ref: utils/hparam_search.py:209-281).

    ``launcher``: optional command-prefix template for multi-host dispatch —
    each trial's command becomes ``launcher.format(device=<assigned
    device>).split() + [python -m clip_gp_tpu_torch.train …]`` (e.g.
    ``--devices host1,host2 --launcher "ssh {device}"``; the remote side
    needs the repo and its environment). With no launcher, ``devices``
    round-robins through ``CUDA_VISIBLE_DEVICES``, the reference's pinning."""
    results: List[Dict[str, Any]] = []
    total = len(trials)
    completed = {"n": 0}
    task_q: "queue.Queue[Trial]" = queue.Queue()
    for i, t in enumerate(trials):
        if devices:
            t.extra_env["CUDA_VISIBLE_DEVICES"] = devices[i % len(devices)]
        task_q.put(t)
    lock = threading.Lock()
    dev_ids = devices or [""]
    semaphores = {d: threading.Semaphore(max(1, jobs_per_device)) for d in dev_ids}
    n_threads = max(1, len(dev_ids) * max(1, jobs_per_device))
    # the children import the package from this checkout
    repo_root = str(Path(__file__).resolve().parents[2])

    def worker():
        while True:
            try:
                trial = task_q.get_nowait()
            except queue.Empty:
                return
            dev = trial.extra_env.get("CUDA_VISIBLE_DEVICES", "")
            sem = semaphores.get(dev, semaphores[dev_ids[0]])
            with sem:
                cmd, env = trial_command(trial, launcher, repo_root)
                kwargs = (
                    {}
                    if verbose
                    else {"stdout": subprocess.DEVNULL, "stderr": subprocess.DEVNULL}
                )
                rc = subprocess.call(cmd, env=env, **kwargs)
                with lock:
                    completed["n"] += 1
                    status = "OK" if rc == 0 else "FAIL"
                    print(
                        f"[{completed['n']}/{total}] {status} "
                        f"dataset={trial.dataset} shots={trial.shots} "
                        f"seed={trial.seed} config={trial.signature()}"
                    )
                    results.append(_result(trial, rc, "subprocess"))
            task_q.task_done()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results


def trial_command(trial: Trial, launcher: Optional[str], repo_root: str
                  ) -> Tuple[List[str], Dict[str, str]]:
    """(argv, env) of one subprocess trial: the child runs
    ``python -m clip_gp_tpu_torch.train`` with the trial's env (its
    ``CUDA_VISIBLE_DEVICES`` pin) and this checkout on ``PYTHONPATH``; a
    ``launcher`` template, formatted with the assigned device, prefixes it."""
    env = os.environ.copy()
    env.update(trial.extra_env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo_root, env.get("PYTHONPATH", "")) if p
    )
    cmd = [sys.executable, "-m", "clip_gp_tpu_torch.train"] + trial.to_argv()
    if launcher:
        dev = trial.extra_env.get("CUDA_VISIBLE_DEVICES", "")
        cmd = launcher.format(device=dev).split() + cmd
    return cmd, env


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run grid experiments")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--devices", default=None,
                    help="comma-separated device ids (subprocess backend)")
    ap.add_argument("--jobs-per-gpu", "--jobs-per-device", type=int, default=1,
                    dest="jobs_per_device")
    ap.add_argument("--experiment-name", default=None)
    ap.add_argument("--backend", choices=["inprocess", "subprocess", "vmap"],
                    default="inprocess")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--no-skip-logged", action="store_true")
    ap.add_argument(
        "--strict-vmap", action="store_true",
        help="error out if a vmapped trial group fails instead of silently "
             "falling back to the in-process backend",
    )
    ap.add_argument(
        "--launcher", default=None,
        help="subprocess-backend command prefix template for multi-host "
             "dispatch, e.g. 'ssh {device}' with --devices host1,host2",
    )
    ap.add_argument(
        "--group-parallel", type=int, default=None,
        help="vmap backend: run up to N trial groups concurrently, one per "
             f"GPU; only 1 (sequential) runs in the port ({MULTI_GPU_ITEM})",
    )
    ap.add_argument(
        "--trial-mesh", nargs="?", const="auto", default=None,
        help="vmap backend: split each group's trial axis over several GPUs; "
             f"not in the port yet ({MULTI_GPU_ITEM})",
    )
    args = ap.parse_args(argv)
    if args.trial_mesh is not None and args.backend != "vmap":
        ap.error("--trial-mesh requires --backend vmap")

    t0 = time.time()
    config_path = Path(args.config_file)
    import yaml  # only the experiment YAML needs PyYAML

    with open(config_path) as f:
        cfg = yaml.safe_load(f)
    cfg["__config_file__"] = str(config_path)
    if args.experiment_name:
        cfg["name"] = args.experiment_name
    elif not cfg.get("name"):
        cfg["name"] = config_path.stem

    trials, meta = build_trials(cfg)
    todo = pending_trials(trials, skip_logged=not args.no_skip_logged)
    # device hints: experiment-YAML key first, CLI flag as fallback
    # (ref: utils/hparam_search.py:159 — cfg.get("devices") or cli_devices)
    dev_str = cfg.get("devices") or args.devices or ""
    devices = [d.strip() for d in str(dev_str).split(",") if d.strip()]
    subprocess_backend = args.backend == "subprocess" or (
        args.backend != "vmap" and bool(devices))
    if not subprocess_backend:
        # this process trains: the GPU, or the CPU only when asked for
        from clip_gp_tpu_torch.core.device import resolve_device

        print(f"Torch device: {resolve_device()}")
    if args.backend == "vmap":
        results = run_trials_vmapped(
            todo, strict=args.strict_vmap, group_parallel=args.group_parallel,
            trial_mesh=1 if args.trial_mesh is not None else None,
        )
    elif subprocess_backend:
        results = run_trials_subprocess(
            todo, devices, args.jobs_per_device, args.verbose,
            launcher=args.launcher,
        )
    else:
        results = run_trials_inprocess(todo)
    exp = meta["experiment_name"]
    out = trials[0].output_root / exp if trials else Path("output") / exp
    print(f"Experiment complete: {exp} -> {out}")
    print(f"Completed in {time.time() - t0} seconds")
    return results


if __name__ == "__main__":
    main()
