"""The ViT-L/14@336px serving cell end to end at a small size on the CPU: a
ViT of 290 tokens (past the strip kernel's 256, where the card takes K1's
key-tiled core) in the configuration's place, entered in the port's
architecture table for the test only, and four classes of 152-px JPEGs
served at 136 px (the cell's 384 to 336). The result line, the traced run, a
lower-precision reference in the program's place failing the comparison,
and a wrong answer planted under the timed path turning ``correct`` false."""

import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import compare, harness  # noqa: E402
from port_bench.tests import small  # noqa: E402
from port_bench.tests.test_port_bench_cells import _emulated, _predict_answer  # noqa: E402

CELL = "vit_l14_336.predict"
LONG_VIT = {"backbone": "TEST-ViT-290", "embed_dim": 32, "image_resolution": 136,
            "vision_layers": 2, "vision_width": 64, "vision_patch_size": 8,
            "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2}
TRAFFIC = {"images": {"classes": 4, "images": 20, "image_size": 152, "seed": 0},
           "check_images": 8, "trainer": small._trainer(136)}


@pytest.fixture(autouse=True)
def long_vit(monkeypatch):
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES, ClipArchitecture

    arch = ClipArchitecture("TEST-ViT-290", 32, 136, 2, 64, 8, transformer_width=64,
                            transformer_heads=1, transformer_layers=2)
    assert (arch.image_resolution // arch.vision_patch_size) ** 2 + 1 == 290
    monkeypatch.setitem(ARCHITECTURES, arch.name, arch)


def _context(seed=3000000001, trace=0):
    harness.set_environment()
    return harness.context(CELL, seed, 0.0, bool(trace), torch.device("cpu"),
                           time.perf_counter(), config=LONG_VIT, traffic=TRAFFIC)


def _run(trace=0):
    from port_bench import run as runner

    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.execute(_context(trace=trace))
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]) if rc == 0 else None


def test_the_cell_prints_one_correct_line():
    rc, line = _run()
    assert rc == 0
    e2e, _ = harness.cell_metrics(harness.benchmark(), CELL)
    assert {m["name"] for m in e2e} == {"predict_images_per_s", "setup_s"}
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert set(line["checks"]) == {"features", "logits", "top5"}


def test_the_traced_run_reads_only_the_cells_metrics():
    rc, line = _run(trace=1)
    assert rc == 0 and line["correct"] is True
    _, layer = harness.cell_metrics(harness.benchmark(), CELL)
    assert {m["name"] for m in layer} == {
        "attention_roofline.vit_l14_336", "attention_share.vit_l14_336",
        "kernels_roofline.predict", "mfu.predict", "device_idle.predict",
        "decode_wait_share.predict", "idle_waiting_decode.predict",
        "decode_ahead_share.predict"}
    # on the CPU only the loader's span metrics have something to read
    assert set(line["metrics"]) <= {"decode_wait_share.predict", "decode_ahead_share.predict"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_lower_precision_fails_the_check(monkeypatch):
    ctx = _context()
    drv = harness.driver(ctx.traffic["kind"])
    monkeypatch.setattr(drv, "products", _emulated)
    readings = drv.control(ctx, lower=True, faults=False)
    assert compare.correct(compare.verdict(readings["sound"], ctx.limits)), readings["sound"]
    assert not compare.correct(compare.verdict(readings["control"], ctx.limits)), readings["control"]


def test_a_wrong_answer_under_the_timed_path_is_not_correct(monkeypatch):
    _predict_answer(monkeypatch)
    rc, line = _run()
    assert rc == 0
    assert line["correct"] is False, line["checks"]
