"""Driver of the ``gp_sweep`` traffic: grid sweeps of the Adapter + GP head
through the port's sweep entry, one after another in one process (closed
loop).

A sweep is the entry's own command, ``clip_gp_tpu_torch.parallel.sweep
--config-file <experiment> --backend vmap --strict-vmap --no-skip-logged``,
over an experiment YAML of the mix: its seeds x its shot counts x its grid.
The grid's keys join the trial axis, so each shot count is one
trial-batched group, and the sweep runs the groups in its sequential
schedule: decode-ahead (the next group's splits and union decode on a host
thread while a group trains), the program's own GP draws (``TrialDraws``)
and every trial's ``metrics.json``.

Set-up generates the image tree (first run of a checkout only), then runs a
one-group sweep of the mix's largest shot count for ``warmup_epochs``
epochs, which builds the kernels and fills the test-feature memo as a
sweep's first group does. The window runs whole sweeps, each on new seeds,
until ``--seconds`` have passed; its rate counts the trials of every sweep
over the time to the end of the last.

``Probe`` watches the groups through two methods of the program,
``VmappedTrials.run`` and ``TrialDraws.__call__``, wrapped for the window's
length and calling the originals unchanged: each group's seconds, steps and
phase timers, the profiler over one group, and the checked group's state
at its first steps and at its eval. Group ``checked_group`` of the first
sweep is held against the plain reference once the window has closed: the
reference trains that group's trials from its own state through every step,
and works the eval and its metrics out again from the program's trained
state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import compare, data, flops, harness
from port_bench.reference import clip as rclip
from port_bench.reference import products
from port_bench.reference import data as rdata
from port_bench.reference import gp as rgp
from port_bench.reference import metrics as rmetrics

STEPS_CHECKED = 3
METRICS = ("top1_acc", "macro_f1", "ece", "aece")


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

def _tree(ctx) -> Dict[str, Path]:
    root = data.caltech_tree(ctx.traffic["dataset"])
    return {"root": root, "images": root / "caltech-101" / "101_ObjectCategories",
            "split": root / "caltech-101" / "split_zhou_Caltech101.json"}


def _sweep(ctx, tree: Dict, tag: str, seeds: List[int], shots: List[int], epochs: int) -> None:
    """One run of the sweep entry over the mix's experiment."""
    import yaml

    from clip_gp_tpu_torch.parallel import sweep

    tr = ctx.traffic
    trainer = json.loads(json.dumps(tr["trainer"]))
    trainer["SEED"] = int(ctx.seed)  # the CLIP weights' seed
    trainer.setdefault("MODEL", {})["BACKBONE_NAME"] = ctx.config["backbone"]
    trainer["OPTIM"]["MAX_EPOCH"] = epochs
    trainer["TRAINER"]["ADAPTER"]["CLIP_ADAPTER_EPOCHS"] = epochs
    ds_yaml = ctx.work / "dataset.yaml"
    ds_yaml.write_text(yaml.safe_dump({"DATASET": {"NAME": tr["dataset"]["name"]}}))
    exp = {"name": "port_bench", "datasets": [tr["dataset"]["key"]], "seeds": seeds,
           "shots": list(shots), "grid": tr["grid"], "dataset_config": str(ds_yaml),
           "root": str(tree["root"]), "output_root": str(ctx.work / "out" / tag), **trainer}
    path = ctx.work / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(exp, sort_keys=False))
    sweep.main(["--config-file", str(path), "--backend", "vmap", "--strict-vmap",
                "--no-skip-logged"])


def _leaves(tree) -> Dict[str, torch.Tensor]:
    from clip_gp_tpu_torch.parallel.trial_specs import tree_leaves

    return {k: v.detach().cpu().clone() for k, v in tree_leaves(tree)}


class Capture:
    """What the check reads of the checked group while it runs: at the draw
    of step ``i`` (``i`` <= 3) the state that steps before it left, at the
    eval's draw the trained state and the group's frozen inputs. The first
    gradient is read from AdamW's first moment after one step
    (``g = m / (1 - beta1)``). These are the runner's own attributes; where
    one is missing, ``missing`` says which, and the run ends as an error of
    the benchmark."""

    def __init__(self, batch: int):
        self.batch = batch
        self.out: Dict = {"loss": []}
        self.missing: List[str] = []

    def __call__(self, runner, kind: str, index: int) -> None:
        try:
            self._read(runner, kind, index)
        except (AttributeError, IndexError, KeyError, TypeError) as e:
            # the runner's layout is not the one read here
            self.missing.append(f"{kind} {index}: {e!r}")

    def _read(self, runner, kind: str, index: int) -> None:
        part = runner._parts[0]
        if kind == "train" and index <= STEPS_CHECKED:
            if index == 0:
                n = STEPS_CHECKED * self.batch
                self.out["union"] = part.feats_e[:, :n].detach().cpu()
                self.out["p0"] = _leaves(part.params)
                return
            self.out["loss"].append(part.losses.detach().cpu().clone())
            if index == 1:
                # a leaf the optimizer holds no moment of has not been
                # stepped: no gradient to read, which the check reads as inf
                state, b1 = part.opt.state, part.opt.b1
                leaves = _dict_leaves(part.params)
                self.out["grad"] = ({k: (state[id(v)]["mu"] / (1.0 - b1)).detach().cpu()
                                     for k, v in leaves.items()}
                                    if all(id(v) in state for v in leaves.values()) else None)
            if index == STEPS_CHECKED:
                self.out["p3"] = _leaves(part.params)
        elif kind == "eval":
            self.out["final_state"] = _leaves(part.params)
            self.out["text"] = runner.text_embeddings.detach().cpu()
            self.out["test"] = runner.feats_test.detach().cpu()
            self.out["gram"] = _gram(runner.spec.gp.buffers["templates_red"][: runner.k].detach().cpu())


def _dict_leaves(tree) -> Dict[str, torch.Tensor]:
    from clip_gp_tpu_torch.parallel.trial_specs import tree_leaves

    return dict(tree_leaves(tree))


class Probe:
    """The window's view of the sweep's groups (see the module's doc)."""

    def __init__(self, ctx, capture: Capture):
        self.ctx, self.capture = ctx, capture
        tr = ctx.traffic
        self.checked, self.traced = int(tr["checked_group"]), int(tr["traced_group"])
        self.sweep = 0
        self.groups: List[Dict] = []
        self.current: Optional[Dict] = None
        self.spans: Dict = {}

    @contextlib.contextmanager
    def watching(self):
        from clip_gp_tpu_torch.parallel import trial_vmap

        run, call = trial_vmap.VmappedTrials.run, trial_vmap.TrialDraws.__call__
        probe = self

        def watched_run(runner, trial_outdirs=None):
            return probe._run(run, runner, trial_outdirs)

        def watched_call(draws, kind, index, shape):
            probe._draw(kind, index)
            return call(draws, kind, index, shape)

        trial_vmap.VmappedTrials.run, trial_vmap.TrialDraws.__call__ = watched_run, watched_call
        try:
            yield self
        finally:
            trial_vmap.VmappedTrials.run, trial_vmap.TrialDraws.__call__ = run, call

    def _is(self, rec: Dict, position: int) -> bool:
        return rec["sweep"] == 0 and rec["position"] == position

    def _run(self, run, runner, trial_outdirs):
        from clip_gp_tpu_torch.runtime.profiling import phase_report

        position = sum(1 for g in self.groups if g["sweep"] == self.sweep)
        rec = {"sweep": self.sweep, "position": position, "runner": runner,
               "outdirs": [Path(d) for d in trial_outdirs or []],
               "seeds": [int(s) for s in runner.seeds], "trials": int(runner.t_trials),
               "shots": int(runner.config.dataset.num_shots), "steps": 0, "trace": None}
        self.groups.append(rec)
        self.current = rec
        trace = harness.Trace() if self.ctx.trace and self._is(rec, self.traced) else None
        before = phase_report()
        t0 = time.perf_counter()
        try:
            if trace is not None:
                trace.__enter__()
                self.spans = {"before": harness.mark_begin("port_bench.group_before_training")}
            return run(runner, trial_outdirs)
        finally:
            if trace is not None:
                for handle in self.spans.values():
                    harness.mark_end(handle)
                self.spans = {}
                trace.__exit__(None, None, None)
                rec["trace"] = trace.summary
            rec["seconds"] = time.perf_counter() - t0
            after = phase_report()
            rec["phases"] = {k: v["total_s"] - before.get(k, {"total_s": 0.0})["total_s"]
                             for k, v in after.items()}
            rec["runner"] = None
            self.current = None
            print(f"group {self.sweep}.{position} shots {rec['shots']} seconds "
                  f"{rec['seconds']:.3f} steps {rec['steps']} " + " ".join(
                      f"{k} {v:.3f}" for k, v in sorted(rec["phases"].items()) if v),
                  file=sys.stderr)

    def _draw(self, kind: str, index: int) -> None:
        rec = self.current
        if rec is None or rec["runner"] is None:
            return
        if kind == "train":
            rec["steps"] += 1
        if self.spans:
            if kind == "train":
                harness.mark("port_bench.step")
                if "before" in self.spans:
                    harness.mark_end(self.spans.pop("before"))
                    self.spans["train"] = harness.mark_begin("port_bench.training")
            elif kind == "eval" and "train" in self.spans:
                harness.mark_end(self.spans.pop("train"))
                self.spans["after"] = harness.mark_begin("port_bench.eval_and_metrics")
        if self._is(rec, self.checked):
            self.capture(rec["runner"], kind, index)


def _union_size(tree: Dict, trial_seeds: List[int], shots: int) -> int:
    split = rdata.read_split(str(tree["split"]), str(tree["images"]))
    items, _ = rdata.union([rdata.fewshot(split["train"], s, shots) for s in trial_seeds])
    return len(items)


def window(ctx, tree: Dict, capture: Capture) -> Dict:
    """Whole sweeps on new seeds until ``ctx.seconds`` have passed."""
    tr = ctx.traffic
    probe = Probe(ctx, capture)
    sweeps = []
    t0 = time.perf_counter()
    with probe.watching():
        while True:
            s = probe.sweep = len(sweeps)
            ts = time.perf_counter()
            _sweep(ctx, tree, f"s{s}", harness.seed_ints(ctx.seed, 100 + s, int(tr["seeds"])),
                   tr["shots"], int(tr["epochs"]))
            sweeps.append({"seconds": time.perf_counter() - ts})
            print(f"sweep {s} seconds {sweeps[-1]['seconds']:.3f}", file=sys.stderr)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    window_s = time.perf_counter() - t0
    for g in probe.groups:
        g["union"] = _union_size(tree, g["seeds"], g["shots"])
        del g["runner"]
    for s, rec in enumerate(sweeps):
        rec["traced"] = any(g["trace"] is not None for g in probe.groups if g["sweep"] == s)
    checked = [g for g in probe.groups if probe._is(g, probe.checked)]
    if len(checked) != 1:
        raise harness.BenchmarkError(
            f"the first sweep ran {sum(g['sweep'] == 0 for g in probe.groups)} groups; "
            f"group {probe.checked} is checked")
    return {"groups": probe.groups, "sweeps": sweeps, "window_s": window_s, "checked": checked[0]}


def run(ctx) -> Dict:
    tr = ctx.traffic
    tree = _tree(ctx)
    _sweep(ctx, tree, "warmup", harness.seed_ints(ctx.seed, 1, int(tr["seeds"])),
           [max(tr["shots"])], int(tr["warmup_epochs"]))
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    capture = Capture(_batch(tr))
    win = window(ctx, tree, capture)
    trials = sum(g["trials"] for g in win["groups"])
    memory = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    prog = program_outputs(capture, win["checked"])
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = reference_outputs(ctx, tree, win["checked"], prog["final_state"], torch.float64,
                            tf32=False)
    checks = compare.verdict(gaps(prog, ref), ctx.limits)
    traced = next((g["trace"] for g in win["groups"] if g["trace"] is not None), None)
    return {
        "setup_s": setup_s, "window_s": win["window_s"], "check_s": time.perf_counter() - t_check,
        "end_to_end": {"sweep_trials_per_min": 60.0 * trials / win["window_s"]},
        "attempted": trials,
        "failed": 0,
        "memory_peak_bytes": memory,
        "checks": checks,
        "trace": traced,
        "record": {"cell": ctx, "groups": win["groups"], "sweeps": win["sweeps"],
                   "window_s": win["window_s"]},
    }


def _batch(tr: Dict) -> int:
    return int(tr["trainer"]["DATALOADER"]["TRAIN_X"]["BATCH_SIZE"])


# ----------------------------------------------------------------------
# the check
# ----------------------------------------------------------------------

def program_outputs(capture: Capture, checked: Dict) -> Dict:
    """The checked group's outputs, on the CPU: what the capture read and
    every trial's ``metrics.json``."""
    cap = capture.out
    need = ("union", "p0", "grad", "p3", "final_state", "text", "test", "gram")
    gone = [k for k in need if k not in cap] + (
        ["loss"] if len(cap["loss"]) != STEPS_CHECKED else [])
    if capture.missing or gone:
        raise harness.BenchmarkError(
            "the check could not read the checked group's state from the program "
            f"(VmappedTrials and its trial slice changed?): unread {gone}; "
            + "; ".join(capture.missing[:5]))
    return {"text": cap["text"], "test": cap["test"], "gram": cap["gram"],
            "union": cap["union"], "loss": torch.stack(cap["loss"]), "grad": cap["grad"],
            "change": {k: cap["p3"][k] - cap["p0"][k] for k in cap["p0"]},
            "trained": {k: cap["final_state"][k] - cap["p0"][k] for k in cap["p0"]},
            "final_state": cap["final_state"],
            "final": [json.loads((d / "metrics.json").read_text())["metrics"]
                      for d in checked["outdirs"]]}


def _gram(red: torch.Tensor) -> torch.Tensor:
    red = red.double()
    return red @ red.transpose(-1, -2)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number compared; one whose side is missing reads inf."""
    def gap(fn, key, *extra):
        if prog.get(key) is None or ref.get(key) is None:
            return float("inf")
        return fn(prog[key], ref[key], *extra)

    final = float("inf")
    if prog.get("final") is not None and ref.get("final") is not None:
        final = max(abs(p[m] - r[m]) for p, r in zip(prog["final"], ref["final"]) for m in METRICS)
    return {
        "text": gap(compare.rows, "text"),
        "pca": gap(compare.scaled, "gram"),
        "union": gap(compare.rows, "union"),
        "test": gap(compare.rows, "test"),
        "loss": gap(compare.scaled, "loss"),
        "grad": gap(compare.leaf_norms, "grad"),
        "step3": gap(compare.leaf_norms, "change", compare.moving(ref["grad"])),
        "trained": gap(compare.leaf_norms, "trained", compare.moving(ref["grad"])),
        "final": final,
    }


class Streams:
    """The GP's standard-normal draws of a trial group, worked out again
    from the trials' seeds: trial ``t`` of seed ``s`` draws from a
    ``torch.Generator`` on the device seeded with the first 64-bit word of
    ``SeedSequence([s, t])`` shifted right by one, one call per draw, in the
    order in which the run makes its draws."""

    def __init__(self, seeds: List[int], device):
        self.gens = []
        for t, seed in enumerate(seeds):
            state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), t]).generate_state(1, np.uint64)[0]
            gen = torch.Generator(device=device)
            gen.manual_seed(int(state >> np.uint64(1)))
            self.gens.append(gen)
        self.device = device

    def __call__(self, shape) -> torch.Tensor:
        return torch.stack([torch.randn(tuple(shape), generator=g, device=self.device)
                            for g in self.gens])


def reference_outputs(ctx, tree: Dict, checked: Dict, final_state: Dict, dtype, tf32: bool,
                      unchanged: bool = False) -> Dict:
    """The checked group computed again by the plain reference in ``dtype``
    (``tf32``: fp32 products in TF32, the control), from the seeds, the
    split and the JPEGs: the towers, the few-shot splits and the union's
    augmentation, the GP's set-up, and every step of every trial from the
    reference's own state. The eval and its metrics are worked out from
    the program's trained state (``final_state``), with the inducing token
    at the reference's own class mean: the token lies in the span of the
    class's templates, where the predictive does not depend on it, and its
    coordinates are in the program's PCA basis. ``unchanged`` plants the
    fault of a step that returns its state unchanged."""
    with products(tf32):
        return _reference(ctx, tree, checked, final_state, dtype, unchanged)


def _reference(ctx, tree, checked, final_state, dtype, unchanged) -> Dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    adapter, optim = tr["trainer"]["TRAINER"]["ADAPTER"], tr["trainer"]["OPTIM"]
    shots, batch = checked["shots"], _batch(tr)
    s_train, s_eval = int(adapter["GP_NUM_MC_SAMPLES_TRAIN"]), int(adapter["GP_NUM_MC_SAMPLES_EVAL"])
    size = int(tr["trainer"]["INPUT"]["SIZE"][0])
    w = rclip.to_device(rclip.random_weights(cfg, int(ctx.seed)), dev, dtype)
    split = rdata.read_split(str(tree["split"]), str(tree["images"]))
    with open(tree["split"]) as f:
        names = {int(lab): name for _, lab, name in json.load(f)["train"]}
    classnames = [names[i] for i in range(len(names))]
    k, m = len(classnames), len(tr["templates"])
    text = rclip.encode_templates(w, cfg, classnames, tr["templates"])

    seeds = checked["seeds"]
    lists = [rdata.fewshot(split["train"], s, shots) for s in seeds]
    items, index = rdata.union(lists)
    aug = rdata.aug_seeds(seeds, tr["dataset"]["name"], shots, len(items))
    feats_u = rclip.encode_image_array(
        w, cfg, rdata.load_many(rdata.load_train, [(p, a, size) for (p, _), a in zip(items, aug)]))
    test_items = split["test"]
    test = rclip.encode_image_array(
        w, cfg, rdata.load_many(rdata.load_eval, [(p, size) for p, _ in test_items]))
    test_labels = np.asarray([lab for _, lab in test_items])
    del w

    t_trials = len(seeds)
    frozen = rgp.setup(text.to(dev), int(adapter["GP_PCA_DIM"]), dtype)
    # trial order: seed-major, then the grid's cells in the traffic's key order
    grid = list(tr["grid"])
    combos = list(itertools.product(*tr["grid"].values()))
    per = [dict(zip(grid, c)) for _ in range(t_trials // len(combos)) for c in combos]
    hp = {"gp_beta": torch.tensor([p.get("TRAINER.ADAPTER.GP_BETA", adapter["GP_BETA"]) for p in per],
                                  dtype=dtype, device=dev),
          "l2_lambda": torch.full((t_trials,), float(adapter["L2_LAMBDA"]), dtype=dtype, device=dev)}
    gp_lr = torch.tensor([p.get("TRAINER.ADAPTER.GP_LR", adapter["GP_LR"]) for p in per],
                         dtype=dtype, device=dev)
    base_lr = torch.full((t_trials,), float(optim["LR"]), dtype=dtype, device=dev)
    state = rgp.init_state(frozen, t_trials, text.shape[-1])
    opt = rgp.AdamW(eps=1e-8, wd=float(optim.get("WEIGHT_DECAY", 0.0)))
    scale = rclip.LOGIT_SCALE
    epochs = int(tr["epochs"])

    # the run's draws, in its order: the zero-shot eval, one per step, the eval
    streams = Streams(seeds, dev)
    streams((s_eval, k, m))
    feats_u = feats_u.to(dev)
    index_t = torch.as_tensor(index, device=dev)
    labels_t = torch.tensor([[lab for _, lab in lst] for lst in lists], device=dev)
    n = index_t.shape[1]
    n_batches = 1 if n <= batch else n // batch
    p0 = {name: v.clone() for name, v in state.items()}
    losses, grad0, change3, union, step = [], None, None, None, 0
    for epoch in range(epochs):
        fac = rgp.cosine_factor(epoch, epochs)
        lrs = {name: (base_lr if name == "visual_proj" else gp_lr) * fac for name in state}
        order = torch.as_tensor(np.stack([rdata.epoch_order(s, epoch, n) for s in seeds]), device=dev)
        pos, lab = index_t.gather(1, order), labels_t.gather(1, order)
        for b in range(n_batches):
            sl = slice(b * batch, min((b + 1) * batch, n))
            feats = feats_u[pos[:, sl]]
            if epoch == 0 and union is None:
                union = feats_u[pos[:, : STEPS_CHECKED * batch]].cpu()
            eps = streams((s_train, k, m)).to(dtype)
            p = {name: v.detach().requires_grad_(True) for name, v in state.items()}
            loss = rgp.loss(p, frozen, feats, lab[:, sl], eps, hp, scale, shots)
            loss.sum().backward()
            grads = {name: (v.grad if v.grad is not None else torch.zeros_like(v))
                     for name, v in p.items()}
            if step < STEPS_CHECKED:
                losses.append(loss.detach().cpu())
            if step == 0:
                grad0 = {name: g.cpu() for name, g in grads.items()}
            if not unchanged:
                state = opt.step(state, grads, lrs)
            step += 1
            if step == STEPS_CHECKED:
                change3 = {name: (state[name] - p0[name]).cpu() for name in state}
    eps_eval = streams((s_eval, k, m)).to(dtype)
    final, ties = [], 0
    with torch.no_grad():
        for t in range(t_trials):
            pt = {name: v[t:t + 1].to(dev, dtype) for name, v in final_state.items()}
            pt["gp/inducing_token"] = frozen["cls_mean_red"][None, :, None, :]
            logits = rgp.eval_logits(pt, frozen, test.to(dev), eps_eval[t:t + 1], scale)[0]
            top2 = logits.topk(2, dim=-1).values
            ties += int(((top2[:, 0] - top2[:, 1]) < 1e-4 * logits.abs().max()).sum())
            final.append(rmetrics.summary(logits.cpu().numpy(), test_labels))
    # images whose two best classes lie within 1e-4 of the largest logit:
    # where the program's top-1 may differ from the reference's by rounding
    print(f"near-ties {ties} of {t_trials * len(test_items)} (trial, image) pairs", file=sys.stderr)
    return {"text": text.cpu(), "gram": _gram(frozen["templates_red"].cpu()), "union": union,
            "test": test.cpu(), "loss": torch.stack(losses) if len(losses) == STEPS_CHECKED else None,
            "grad": grad0, "change": change3,
            "trained": {name: (state[name] - p0[name]).cpu() for name in state}, "final": final}


# ----------------------------------------------------------------------
# the readings that the limits are set from (``control.py``)
# ----------------------------------------------------------------------

def _fault_half_batch():
    """Each step's loss over half its batch, the mean over the rest."""
    from clip_gp_tpu_torch.parallel.trial_specs import AdapterSpec

    loss = AdapterSpec.loss

    def half(self, p, c, feats, labels, draw, hps):
        b = max(1, feats.shape[1] // 2)
        return loss(self, p, c, feats[:, :b], labels[:, :b], draw, hps)

    return harness.patched(AdapterSpec, "loss", half)


def _fault_answer():
    """Each trial's metrics from the logits of the trial before it: an
    answer written where another's belongs."""
    from clip_gp_tpu_torch.parallel.trial_vmap import VmappedTrials

    result = VmappedTrials._trial_result
    previous: Dict = {}

    def neighbour(self, t, seed, logits, *rest, **kw):
        use = previous.get("logits", logits)
        previous["logits"] = logits
        return result(self, t, seed, use, *rest, **kw)

    return harness.patched(VmappedTrials, "_trial_result", neighbour)


def _checked_only(ctx, tree: Dict) -> Dict:
    """The program's outputs of the checked group alone: a one-group sweep
    of the checked group's shot count on the first sweep's seeds."""
    tr = ctx.traffic
    capture = Capture(_batch(tr))
    one = dataclasses.replace(ctx, traffic={**tr, "shots": [tr["shots"][int(tr["checked_group"])]],
                                            "checked_group": 0})
    win = window(one, tree, capture)
    return {"program": program_outputs(capture, win["checked"]), "checked": win["checked"]}


def control(ctx, lower: bool, faults: bool) -> Dict:
    """{"sound": gaps[, "control": gaps][, each fault: gaps]} against the
    float64 reference, on the checked group at the cell's size. The
    control (``lower``) is the reference in fp32 with TF32 products; the
    faults are planted in the program (half a batch, an answer written to
    another trial) or in the reference put in its place (a step that
    returns its state unchanged)."""
    tree = _tree(ctx)
    sound = _checked_only(ctx, tree)
    final_state = sound["program"]["final_state"]
    ref = reference_outputs(ctx, tree, sound["checked"], final_state, torch.float64, tf32=False)
    out = {"sound": gaps(sound["program"], ref)}
    if lower:
        low = reference_outputs(ctx, tree, sound["checked"], final_state, torch.float32, tf32=True)
        out["control"] = gaps(low, ref)
    if faults:
        with _fault_half_batch():
            out["half_batch"] = gaps(_checked_only(ctx, tree)["program"], ref)
        with _fault_answer():
            out["answer"] = gaps(_checked_only(ctx, tree)["program"], ref)
        still = reference_outputs(ctx, tree, sound["checked"], final_state, torch.float64,
                                  tf32=False, unchanged=True)
        out["unchanged"] = gaps(still, ref)
    return out


def group_flops(cfg: Dict, tr: Dict, rec: Dict) -> float:
    """Model operations of one group: the text encode of every class
    template, the union's image encode, every GP step, the final eval."""
    adapter = tr["trainer"]["TRAINER"]["ADAPTER"]
    k, m = tr["dataset"]["classes"], len(tr["templates"])
    d, red = cfg["embed_dim"], int(adapter["GP_PCA_DIM"])
    t = rec["trials"]
    return (k * m * flops.text_flops(cfg) + rec["union"] * flops.image_flops(cfg)
            + rec["steps"] * flops.gp_step_flops(t, _batch(tr), int(adapter["GP_NUM_MC_SAMPLES_TRAIN"]), k, m, d, red)
            + flops.gp_eval_flops(t, tr["dataset"]["test"], int(adapter["GP_NUM_MC_SAMPLES_EVAL"]), k, m, d, red))
