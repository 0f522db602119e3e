"""Cells at a size the CPU runs in seconds: the TEST-RN and TEST-ViT towers
of the port's architecture table, four classes of 64- or 32-pixel images,
and a recipe cut to match (batch 4, so that three steps fit in an epoch)."""

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TEST_RN = {"backbone": "TEST-RN", "embed_dim": 32, "image_resolution": 64,
           "vision_layers": [1, 1, 1, 1], "vision_width": 8, "vision_patch_size": None,
           "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2}
TEST_VIT = {"backbone": "TEST-ViT", "embed_dim": 32, "image_resolution": 32,
            "vision_layers": 2, "vision_width": 64, "vision_patch_size": 8,
            "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2}


def _trainer(size):
    tr = copy.deepcopy(json.loads((ROOT / "port_bench/traffic/gp_sweep.json").read_text())["trainer"])
    tr["DATALOADER"] = {"TRAIN_X": {"BATCH_SIZE": 4}, "TEST": {"BATCH_SIZE": 8}, "NUM_WORKERS": 2}
    tr["INPUT"]["SIZE"] = [size, size]
    return tr


CELLS = {
    "rn50.gp_sweep": (TEST_RN, {
        "dataset": {"key": "caltech101", "name": "Caltech101", "classes": 4, "train": 24,
                    "val": 8, "test": 12, "image_size": 64, "seed": 0},
        "seeds": 2, "shots": [2, 3], "checked_group": 1, "traced_group": 0, "epochs": 2,
        "trainer": _trainer(64)}),
    "vit_b16.predict": (TEST_VIT, {
        "images": {"classes": 4, "images": 20, "image_size": 32, "seed": 0},
        "check_images": 8, "trainer": _trainer(32)}),
}


def context(cell, seed=3000000001, trace=0):
    """The context of a run of ``cell`` at the small size on the CPU."""
    import torch

    from port_bench import harness

    harness.set_environment()
    config, traffic = CELLS[cell]
    return harness.context(cell, seed, 0.0, bool(trace), torch.device("cpu"),
                           time.perf_counter(), config=config, traffic=traffic)


def run(cell, seed=3000000001, trace=0):
    """Run ``cell`` in this process at the small size; returns (rc, line)."""
    import io
    from contextlib import redirect_stdout

    from port_bench import run as runner

    ctx = context(cell, seed, trace)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.execute(ctx)
    last = out.getvalue().strip().splitlines()[-1] if out.getvalue().strip() else ""
    return rc, (json.loads(last) if rc == 0 else None)


def run_subprocess(cell, seed=3000000001, trace=0):
    """The same in a fresh interpreter (what it loads is its own)."""
    code = ("import sys, json; sys.path.insert(0, %r); from port_bench.tests import small; "
            "rc, line = small.run(%r, %d, %d); print(json.dumps(line)); sys.exit(rc)"
            % (str(ROOT), cell, seed, trace))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    return proc.returncode, (json.loads(line) if proc.returncode == 0 else None), proc.stderr
