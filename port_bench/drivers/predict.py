"""Driver of the ``predict`` traffic: the serving path of
``clip_gp_tpu_torch/predict.py`` classifying one folder of images after
another (closed loop), with the model held by the serving process.

Set-up writes a run directory with the port's own trainer and checkpoint
save: an Adapter + GP head of the mix's recipe whose trainable state the
benchmark draws from the seed on the device (``head_state``), and its
``config.json``. It then loads the run as ``predict.py`` does (config from
the run, class names from the checkpoint, ``build_model``, ``load_model``)
and serves the folder once to warm every shape. Each job of the window is
``predict.py``'s folder path: a ``BatchLoader`` with the eval transform,
``encode_images_batched``, ``predict_logits`` (the GP's MC logits),
softmax and top-k. The rate counts the images of every job the window ran
over the time to the end of the last.

A sample of one job's images, drawn from the seed among the first two
jobs, is checked against the plain reference once the window has closed.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from port_bench import compare, data, harness
from port_bench.reference import clip as rclip
from port_bench.reference import products
from port_bench.reference import data as rdata
from port_bench.reference import gp as rgp


def head_state(init: Dict, seed: int, device) -> Dict:
    """The served head's trainable state, drawn from the seed: the
    projection near the identity, the template part of the variational
    mean and covariance and the biases and kernel variance around their
    initial values. The inducing token, its mean and its covariance row
    keep their initial values: the token lies at the class mean, in the
    span of the class's templates, where it carries no weight."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    gp = init["gp"]
    d = init["visual_proj"].shape[0]
    k, p = gp["variational_mean"].shape
    m = p - 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    vm = gp["variational_mean"].detach().clone()
    vm[:, :m] += 0.5 * randn(k, m)
    chol = gp["chol_variational_covar"].detach().clone()
    chol[:, :m, :m] += 0.1 * torch.tril(randn(k, m, m), -1) + 0.1 * torch.diag_embed(randn(k, m).abs())
    return {
        "visual_proj": torch.eye(d, device=device) + 0.01 * randn(d, d),
        "gp": {**{n: v.detach().clone() for n, v in gp.items()},
               "variational_mean": vm, "chol_variational_covar": chol,
               "cls_bias": 0.1 * randn(k, 1), "tmp_bias": 0.1 * randn(1, m),
               "raw_variance": 0.3 * randn(k)},
    }


def _config(ctx, run_dir: Path):
    from clip_gp_tpu_torch.core.config import Config, merge_config_dict

    config = Config()
    merge_config_dict(config, json.loads(json.dumps(ctx.traffic["trainer"])))
    config.model.backbone_name = ctx.config["backbone"]
    config.seed = int(ctx.seed)
    config.output_dir = str(run_dir)
    return config


class Server:
    """The serving process: the run directory written and loaded as
    ``predict.py`` loads it, and its folder job."""

    def __init__(self, ctx):
        import clip_gp_tpu_torch.methods  # noqa: F401  (registers the trainers)
        from clip_gp_tpu_torch.core.config import config_from_dict, save_config_to_file
        from clip_gp_tpu_torch.core.registry import build_trainer
        from clip_gp_tpu_torch.data.datum import Datum
        from clip_gp_tpu_torch.predict import _PredictDataManager, list_images
        from clip_gp_tpu_torch.runtime.trainer_base import (
            read_checkpoint_classnames,
            resolve_checkpoint_path,
        )

        tr = self.traffic = ctx.traffic
        folder = data.image_folder(tr["images"])
        classnames = data.classnames(tr["images"]["classes"])
        run_dir = ctx.work / "run"
        config = _config(ctx, run_dir)
        writer = build_trainer(config, _PredictDataManager(classnames))
        writer.build_model()
        state = head_state(writer.params, harness.seed_ints(ctx.seed, 5, 1)[0], ctx.device)
        writer.load_trainable_state(state)
        writer.save_model(0, str(run_dir))
        save_config_to_file(config, str(run_dir / "config.json"))
        self.head = {k: v.detach().cpu() for k, v in
                     [("visual_proj", state["visual_proj"])]
                     + [(f"gp/{n}", v) for n, v in state["gp"].items()]}
        del writer, state
        gc.collect()

        self.config = config_from_dict(json.loads((run_dir / "config.json").read_text()))
        served = read_checkpoint_classnames(resolve_checkpoint_path(str(run_dir)))
        self.trainer = build_trainer(self.config, _PredictDataManager(served))
        self.trainer.build_model()
        if self.trainer.load_model(str(run_dir)) == 0:
            raise RuntimeError("the run directory's checkpoint did not load")
        self.paths = list_images(folder)
        self.source = [Datum(impath=str(p), label=0) for p in self.paths]

    def _spawned(self) -> int:
        """Generators the run's key stream has handed out (the MC draw of
        a job is the next one)."""
        try:
            return self.trainer.keys._seq.n_children_spawned
        except AttributeError as e:
            raise harness.BenchmarkError(
                "the check could not read which generator of the run's key stream a "
                f"job draws from (the trainer's KeySequence changed?): {e!r}") from None

    def job(self) -> Dict:
        """``predict.py``'s folder path over the folder, once."""
        from clip_gp_tpu_torch.data.pipeline import BatchLoader
        from clip_gp_tpu_torch.data.transforms import build_transform

        trainer, config = self.trainer, self.config
        spawned = self._spawned()
        loader = BatchLoader(self.source, build_transform(config, is_train=False),
                             config.dataloader.batch_size_test,
                             num_workers=config.dataloader.num_workers)
        _, feats = trainer.encode_images_batched(loader)
        with torch.no_grad():
            logits = trainer.predict_logits(
                torch.from_numpy(feats).to(trainer.device)).cpu().numpy()
        z = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(z)
        probs = e / e.sum(axis=1, keepdims=True)
        top = np.argsort(-probs, axis=1)[:, :int(self.traffic["topk"])]
        if self._spawned() != spawned + 1:
            raise harness.BenchmarkError("a job drew other than one generator of the run's key stream")
        return {"feats": feats, "logits": logits, "top": top,
                "probs": np.take_along_axis(probs, top, axis=1), "key": spawned}

    def sample(self, ctx, out: Dict):
        """(the program's outputs, paths) of the images checked, drawn from
        the seed."""
        n = len(self.paths)
        pick = np.sort(np.random.default_rng(harness.seed_ints(ctx.seed, 4, 1)[0]).choice(
            n, size=min(int(self.traffic["check_images"]), n), replace=False))
        prog = {"feats": out["feats"][pick], "logits": out["logits"][pick],
                "top": out["top"][pick], "probs": out["probs"][pick]}
        return prog, [str(self.paths[i]) for i in pick]


def run(ctx) -> Dict:
    from clip_gp_tpu_torch.ops.flash_attention import LAUNCHES

    tr = ctx.traffic
    server = Server(ctx)
    for _ in range(int(tr["warmup_jobs"])):
        server.job()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    checked = harness.seed_ints(ctx.seed, 3, 1)[0] % 2
    jobs, kept = [], None
    t0 = time.perf_counter()
    while True:
        j = len(jobs)
        launches = dict(LAUNCHES)
        tj = time.perf_counter()
        trace = harness.Trace() if ctx.trace and j == 0 else None
        if trace is not None:
            trace.__enter__()
        try:
            out = server.job()
        finally:
            if trace is not None:
                trace.__exit__(None, None, None)
        jobs.append({"seconds": time.perf_counter() - tj, "images": len(server.paths),
                     "launches": {k: v - launches[k] for k, v in LAUNCHES.items()},
                     "trace": None if trace is None else trace.summary})
        print(f"job {j} seconds {jobs[-1]['seconds']:.3f}", file=sys.stderr)
        if j == checked:
            kept = out
        if time.perf_counter() - t0 >= ctx.seconds and len(jobs) >= 2:
            break
    window_s = time.perf_counter() - t0
    images = sum(x["images"] for x in jobs)
    memory = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    prog, paths = server.sample(ctx, kept)
    head = server.head
    del server
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = reference_outputs(ctx, head, paths, kept["key"], torch.float64, tf32=False)
    checks = compare.verdict(gaps(prog, ref), ctx.limits)
    return {
        "setup_s": setup_s, "window_s": window_s, "check_s": time.perf_counter() - t_check,
        "end_to_end": {"predict_images_per_s": images / window_s},
        "attempted": images,
        "failed": 0,
        "memory_peak_bytes": memory,
        "checks": checks,
        "trace": jobs[0]["trace"],
        "record": {"cell": ctx, "jobs": jobs, "window_s": window_s},
    }


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    probs_r = np.take_along_axis(ref["probs"], prog["top"], axis=1)
    return {"features": compare.rows(prog["feats"], ref["feats"]),
            "logits": compare.scaled(prog["logits"], ref["logits"]),
            "top5": compare.largest(prog["probs"], probs_r)}


def key_draw(seed: int, index: int, shape, device) -> torch.Tensor:
    """The standard-normal draws of the run's ``index``-th generator: the
    run seed's ``SeedSequence`` child ``index`` seeds a ``torch.Generator``
    on the device."""
    child = np.random.SeedSequence(int(seed) & (2 ** 64 - 1)).spawn(index + 1)[index]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(child.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1)))
    return torch.randn(tuple(shape), generator=gen, device=device)


def reference_outputs(ctx, head: Dict, paths, key_index: int, dtype, tf32: bool) -> Dict:
    """Features, MC logits and probabilities of ``paths`` by the plain
    reference in ``dtype`` (``tf32``: fp32 products in TF32, the control),
    from the seed, the served head's state and the JPEGs."""
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    adapter = tr["trainer"]["TRAINER"]["ADAPTER"]
    with products(tf32), torch.no_grad():
        w = rclip.to_device(rclip.random_weights(cfg, int(ctx.seed)), dev, dtype)
        text = rclip.encode_templates(w, cfg, data.classnames(tr["images"]["classes"]),
                                      tr["templates"])
        size = int(tr["trainer"]["INPUT"]["SIZE"][0])
        feats = rclip.encode_image_array(
            w, cfg, rdata.load_many(rdata.load_eval, [(p, size) for p in paths])).to(dev)
        del w
        frozen = rgp.setup(text, int(adapter["GP_PCA_DIM"]), dtype)
        state = {n: v.to(dev, dtype)[None] for n, v in head.items()}
        state["gp/inducing_token"] = frozen["cls_mean_red"][None, :, None, :]
        s, (k, m) = int(adapter["GP_NUM_MC_SAMPLES_EVAL"]), text.shape[:2]
        eps = key_draw(ctx.seed, key_index, (s, k, m), dev).to(dtype)[None]
        logits = rgp.eval_logits(state, frozen, feats, eps, rclip.LOGIT_SCALE)[0]
    probs = torch.softmax(logits, dim=-1)
    return {"feats": feats.cpu(), "logits": logits.cpu(), "probs": probs.cpu().numpy()}


def _fault_answer():
    """Every answer's first logit raised by one where ``predict_logits``
    produces it."""
    from clip_gp_tpu_torch.methods.adapter import Trainer

    logits = Trainer.predict_logits

    def altered(self, features):
        z = logits(self, features)
        z[:, 0] += 1.0
        return z

    return harness.patched(Trainer, "predict_logits", altered)


def control(ctx, lower: bool, faults: bool) -> Dict:
    """{"sound": gaps[, "control": gaps][, "answer": gaps]} against the
    float64 reference on one job's sample at the cell's size. The control
    (``lower``) is the reference in fp32 with TF32 products, read at the
    program's top-5; the fault is planted in the program."""
    server = Server(ctx)
    out = server.job()
    prog, paths = server.sample(ctx, out)
    readings = {}
    if faults:
        with _fault_answer():
            altered = server.job()
        readings["answer"] = server.sample(ctx, altered)[0]
    head = server.head
    del server
    gc.collect()
    ref = reference_outputs(ctx, head, paths, out["key"], torch.float64, tf32=False)
    result = {"sound": gaps(prog, ref)}
    if lower:
        low = reference_outputs(ctx, head, paths, out["key"], torch.float32, tf32=True)
        rows = np.arange(len(low["probs"]))[:, None]
        low = {**low, "top": prog["top"], "probs": low["probs"][rows, prog["top"]]}
        result["control"] = gaps(low, ref)
    if faults:
        # the altered job drew the next generator of the key stream
        ref_next = reference_outputs(ctx, head, paths, out["key"] + 1, torch.float64, tf32=False)
        result["answer"] = gaps(readings["answer"], ref_next)
    return result
