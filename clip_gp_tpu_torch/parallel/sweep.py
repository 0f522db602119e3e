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

  Several devices: ``--group-parallel N`` runs up to N groups at once,
  worker w pinned to device w mod n_devices (dataset-sticky buckets);
  ``--trial-mesh N|auto`` splits each group's trial axis over up to N
  devices. Without either, one worker per device, capped by the number of
  datasets (one device: the sequential schedule above).

Run as ``python -m clip_gp_tpu_torch.parallel.sweep --config-file exp.yaml
[--backend inprocess|subprocess|vmap]``, or through
``python -m clip_gp_tpu_torch.parallel.run_experiment exp.yaml [args]``.
The in-process and vmap backends run on the GPU, or on the CPU with
``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` (``core.device.resolve_device``); the
subprocess children resolve their own device the same way. A sweep never
splits one trial's extraction batch over the devices
(``CLIP_GP_TPU_TORCH_SHARD_EXTRACTION=0`` while it runs): its parallelism
is trials and groups over devices.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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


def _no_extraction_sharding(fn):
    """Switch off the trainer's batch-sharded feature extraction
    (``parallel/mesh.maybe_sharded_encode``) while a sweep runs, as the JAX
    package does. A sweep's parallelism is trials and groups over devices;
    a per-trial encode over every device would fight the group-parallel
    scheduler, and the sequential and group-parallel sweeps stay equal bit
    for bit (chunked and whole-batch encodes may differ at the ULP level,
    and pinned workers never shard). Subprocess children inherit the
    variable."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        prev = os.environ.get("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION")
        os.environ["CLIP_GP_TPU_TORCH_SHARD_EXTRACTION"] = "0"
        try:
            return fn(*args, **kwargs)
        finally:
            if prev is None:
                os.environ.pop("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION", None)
            else:
                os.environ["CLIP_GP_TPU_TORCH_SHARD_EXTRACTION"] = prev

    return wrapped

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


@_no_extraction_sharding
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


def _group_trial_mesh(n_trials: int, devices, requested: int):
    """The devices one trial group's [T, ...] trial axis splits over: the
    first m, m the largest divisor of T at most min(requested, devices) (the
    axis splits evenly or not at all, as the JAX package's ``NamedSharding``
    placement). None when fewer than two devices would take part."""
    cap = min(int(requested), len(devices))
    m = 1
    for d in range(2, cap + 1):
        if n_trials % d == 0:
            m = d
    if m < 2:
        return None
    return list(devices[:m])


@_no_extraction_sharding
def run_trials_vmapped(
    trials: List[Trial], strict: bool = False,
    group_parallel: Optional[int] = None,
    trial_mesh: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Group trials that differ only by seed (or by grid values that join the
    trial axis) and train each group as one trial-batched program. Trials
    the gate does not admit run in-process. A group that fails falls back
    to the in-process backend with a counted ``[vmap] ... fallback`` line
    (the JAX package's behaviour); with ``strict`` it raises instead.

    ``group_parallel``: run up to N groups at once on host threads, worker w
    pinned to local device w mod n_devices (``core.device.pinned_device``),
    the counterpart of the reference's process-per-GPU pinning. Groups go to
    workers per dataset (dataset-sticky), so each eval split is encoded once;
    when workers outnumber datasets the buckets split to (dataset, shots).
    Workers may outnumber devices: co-resident groups share a device. A
    strict failure stops every worker. Default (None): one worker per local
    device, capped by the dataset count; 1: sequential.

    ``trial_mesh``: split each group's trial axis over up to N local devices
    (``VmappedTrials(mesh=...)``, ``_group_trial_mesh``); a group whose size
    has no divisor >= 2 within the budget runs unsharded. Mutually exclusive
    with ``group_parallel`` > 1: trial-mesh spreads one group over the
    devices, group-parallel gives different groups different devices.

    CoCoOp groups take the in-process backend, the JAX runner's default on
    one device with a sequential schedule; ``strict``,
    ``CLIP_GP_TPU_TORCH_VMAP_COCOOP=1``, a parallel schedule or a usable
    trial mesh trains them on the trial axis.

    Decode-ahead (sequential schedule only): when a feature-cached group
    reaches training (``on_before_train``), a ``DecodePrefetcher`` samples
    the next group's splits and decodes its train union on a host thread,
    and the next group adopts it.
    ``CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH=1`` runs the groups strictly
    one after another; the draws are the same either way."""
    if trial_mesh and group_parallel and group_parallel > 1:
        raise ValueError(
            "--trial-mesh and --group-parallel are mutually exclusive: "
            "the first shards one group over all devices, the second pins "
            "whole groups to single devices"
        )
    from clip_gp_tpu_torch.core import device as device_mod
    from clip_gp_tpu_torch.parallel.trial_vmap import (
        DecodePrefetcher,
        run_vmapped_trials,
        vmappable_config_keys,
    )

    vmappable_keys = vmappable_config_keys()
    groups, configs = group_trials(trials)
    local = device_mod.local_devices()

    results: List[Dict[str, Any]] = []
    leftovers: List[Trial] = []
    n_fallback_groups = 0
    force_cocoop = os.environ.get("CLIP_GP_TPU_TORCH_VMAP_COCOOP") == "1"

    # Would this sweep schedule groups concurrently? In-process trials use
    # the global RNG and run one after another, so CoCoOp's in-process
    # routing below applies only where the schedule is sequential anyway
    n_sweep_datasets = len({g[0].dataset for g in groups.values()})
    parallel_scheduler = (group_parallel or 0) > 1 or (
        not trial_mesh and len(local) > 1 and n_sweep_datasets > 1)

    work_items: List[Tuple] = []
    for key, group in groups.items():
        config = configs[key]
        method = str(config.trainer_name)
        if not _vmap_supported(config, len(group)):
            # head variants the trial-batched runner doesn't model
            leftovers.extend(group)
            continue
        mesh = None
        if trial_mesh:
            mesh = _group_trial_mesh(len(group), local, trial_mesh)
            if mesh is not None:
                print(f"[vmap] trial-mesh: group {key} shards {len(group)} "
                      f"trial(s) over {len(mesh)} device(s)")
            else:
                print(f"[vmap] trial-mesh: group {key} ({len(group)} trials) "
                      "has no divisor >= 2 within the device budget; running "
                      "unsharded")
        if (method == "Adapter-CoCoOp" and mesh is None and not strict
                and not parallel_scheduler and not force_cocoop):
            print(
                f"[vmap] group {key}: Adapter-CoCoOp routes to the in-process "
                "backend on one device (the JAX runner's default); "
                "--trial-mesh, --strict-vmap or CLIP_GP_TPU_TORCH_VMAP_COCOOP=1 "
                "trains it on the trial axis"
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
        work_items.append((key, group, config, method, seeds, overrides, outdirs,
                           mesh))

    lock = threading.Lock()
    strict_errors: List[BaseException] = []

    def _run_group(item, prefetched=None, start_next=None) -> None:
        nonlocal n_fallback_groups
        key, group, config, method, seeds, overrides, outdirs, mesh = item
        try:
            if prefetched is not None:
                # adopt the decode-ahead runner: its splits are sampled and
                # its union decode is under way or done
                prefetched.runner.on_before_train = start_next
                prefetched.runner.run(outdirs)
            else:
                run_vmapped_trials(
                    config, seeds, outdirs, trial_overrides=overrides, method=method,
                    on_before_train=start_next, mesh=mesh,
                )
        except Exception as e:
            import traceback

            if prefetched is not None:
                prefetched.cancel()
            traceback.print_exc()
            with lock:
                if strict:
                    err = RuntimeError(f"vmapped group {key} failed under --strict-vmap")
                    err.__cause__ = e
                    strict_errors.append(err)
                    return
                n_fallback_groups += 1
                print(
                    f"[ERROR] vmapped group {key} failed ({e}); "
                    "falling back to in-process (use --strict-vmap to error)"
                )
                leftovers.extend(group)
            return
        with lock:
            for t in group:
                (t.format_outdir() / "log.txt").touch()  # skip-if-done
                results.append(_result(t, 0, "vmap"))
                print(
                    f"[vmap] OK method={method} dataset={t.dataset} "
                    f"shots={t.shots} seed={t.seed} config={t.signature()}"
                )

    # dataset-sticky buckets: all of a dataset's groups run on one worker so
    # its eval split is memo-encoded once, on that worker's device
    buckets: Dict[Any, List[Tuple]] = {}
    for item in work_items:
        buckets.setdefault(item[1][0].dataset, []).append(item)
    if group_parallel:
        # explicit: workers may outnumber devices (co-resident groups share
        # one; the in-flight memo lock stops duplicate eval encodes). If the
        # datasets cannot feed that many workers, split the buckets down to
        # (dataset, shots)
        n_workers = max(1, group_parallel)
        if n_workers > len(buckets):
            buckets = {}
            for item in work_items:
                buckets.setdefault((item[1][0].dataset, item[1][0].shots),
                                   []).append(item)
        n_workers = min(n_workers, len(buckets) or 1)
    elif trial_mesh:
        # the groups spread over the devices' trial axis; the schedule
        # itself stays sequential (with decode-ahead)
        n_workers = 1
    else:
        n_workers = max(1, min(len(local), len(buckets) or 1))

    if n_workers <= 1:
        prefetch_on = (os.environ.get("CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH") != "1"
                       and len(work_items) > 1)
        prefetchers: List[Any] = [None] * len(work_items)

        def _starter(i: int):
            def start() -> None:
                j = i + 1
                if not prefetch_on or j >= len(work_items) or prefetchers[j] is not None:
                    return
                key_j, _, config_j, method_j, seeds_j, overrides_j, _, mesh_j = \
                    work_items[j]
                try:
                    prefetchers[j] = DecodePrefetcher(
                        config_j, seeds_j, trial_overrides=overrides_j,
                        method=method_j, mesh=mesh_j).start()
                except Exception as e:
                    # the group's own run meets the same error and reports it
                    print(f"[vmap] decode-ahead: group {key_j} not prefetched ({e})")
                    return
                print(f"[vmap] decode-ahead: prefetching group {j + 1}/{len(work_items)}")

            return start

        for i, item in enumerate(work_items):
            _run_group(item, prefetched=prefetchers[i], start_next=_starter(i))
            if strict_errors:
                for pf in prefetchers:
                    if pf is not None and not pf.consumed:
                        pf.cancel()
                raise strict_errors[0]
    else:
        # no decode-ahead on a parallel schedule: the workers' own decodes
        # already overlap other workers' training
        print(f"[vmap] scheduling {len(work_items)} trial group(s) over "
              f"{n_workers} worker(s) / {len(local)} device(s)")

        def _worker(wid: int, my_items: List[Tuple]) -> None:
            # no device to pin on a host without a GPU or a CPU request:
            # each group's runner then raises, as the sequential path's does
            dev = local[wid % len(local)] if local else None
            with (device_mod.pinned_device(dev) if dev is not None
                  else contextlib.nullcontext()):
                for item in my_items:
                    with lock:
                        if strict_errors:
                            return
                    _run_group(item)

        assignments: List[List[Tuple]] = [[] for _ in range(n_workers)]
        for i, bucket in enumerate(sorted(buckets, key=str)):
            assignments[i % n_workers].extend(buckets[bucket])
        threads = [threading.Thread(target=_worker, args=(i, items), daemon=True)
                   for i, items in enumerate(assignments)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if strict_errors:
            raise strict_errors[0]
        results.sort(key=lambda r: r["index"])

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


@_no_extraction_sharding
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
        help="vmap backend: run up to N trial groups concurrently, worker w "
             "pinned to local device w mod n_devices (default: one worker per "
             "device, dataset-sticky; 1 = sequential)",
    )
    ap.add_argument(
        "--trial-mesh", nargs="?", const="auto", default=None,
        help="vmap backend: split each trial group's [T, ...] state over up "
             "to N local devices ('auto' or no value = all local devices). "
             "Pure placement: top-1 identical to unsharded, calibration "
             "metrics within float tolerance. Mutually exclusive with "
             "--group-parallel: trial-mesh splits ONE group across devices, "
             "group-parallel runs DIFFERENT groups on different devices",
    )
    args = ap.parse_args(argv)
    trial_mesh = None
    if args.trial_mesh is not None:
        if args.backend != "vmap":
            ap.error("--trial-mesh requires --backend vmap")
        if str(args.trial_mesh).lower() == "auto":
            trial_mesh = 1 << 30  # capped at the local device count
        else:
            try:
                trial_mesh = int(args.trial_mesh)
            except ValueError:
                ap.error(
                    f"--trial-mesh expects an integer or 'auto', got "
                    f"{args.trial_mesh!r}"
                )
            if trial_mesh < 2:
                ap.error("--trial-mesh needs >= 2 devices (or 'auto')")

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
            trial_mesh=trial_mesh,
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
