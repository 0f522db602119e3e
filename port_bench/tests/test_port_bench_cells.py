"""Both cells end to end at a small size on the CPU: the result line, the
traced run, a lower-precision reference in the program's place failing the
comparison, and each fault a cell can have, planted under the timed path,
turning ``correct`` false."""

import contextlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import compare, harness  # noqa: E402
from port_bench.tests import small  # noqa: E402

CELLS = list(small.CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_one_correct_line(cell):
    rc, line, err = small.run_subprocess(cell)
    assert rc == 0, err[-3000:]
    e2e, _ = harness.cell_metrics(harness.benchmark(), cell)
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    for name, c in line["checks"].items():
        assert f"check {name} " in err


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_per_layer_metrics(cell):
    rc, line = small.run(cell, trace=1)
    assert rc == 0 and line["correct"] is True
    _, layer = harness.cell_metrics(harness.benchmark(), cell)
    assert set(line["metrics"]) <= {m["name"] for m in layer}
    # on the CPU only the program's phase timers have something to read
    assert bool(line["metrics"]) == (cell == "rn50.gp_sweep")
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _round_tf32(x):
    """fp32 with the mantissa cut to TF32's 10 bits (round to nearest)."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    """The CPU's stand-in for TF32: every product's fp32 operands rounded to
    10 mantissa bits, the sums in fp32."""
    saved = (torch.matmul, torch.Tensor.__matmul__, torch.einsum, torch.nn.functional.conv2d)

    def wrap(fn):
        return lambda *a, **k: fn(*[_round_tf32(x) for x in a], **k)

    def einsum(eq, *ops):
        return saved[2](eq, *[_round_tf32(x) for x in ops])

    torch.matmul, torch.Tensor.__matmul__ = wrap(saved[0]), wrap(saved[1])
    torch.einsum, torch.nn.functional.conv2d = einsum, wrap(saved[3])
    try:
        yield
    finally:
        torch.matmul, torch.Tensor.__matmul__, torch.einsum, torch.nn.functional.conv2d = saved


@contextlib.contextmanager
def _emulated(tf32):
    """The reference's ``products`` on the CPU, where TF32 stands for the
    rounding of ``tf32_products``."""
    with tf32_products() if tf32 else contextlib.nullcontext():
        yield


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_fails_the_check(cell, monkeypatch):
    ctx = small.context(cell)
    drv = harness.driver(ctx.traffic["kind"])
    monkeypatch.setattr(drv, "products", _emulated)
    readings = drv.control(ctx, lower=True, faults=False)
    assert compare.correct(compare.verdict(readings["sound"], ctx.limits)), readings["sound"]
    assert not compare.correct(compare.verdict(readings["control"], ctx.limits)), readings["control"]


def _unchanged_state(monkeypatch):
    from clip_gp_tpu_torch.parallel.trial_specs import TrialOptimizer

    def step(self, leaves):
        for p, _ in leaves:
            p.grad = None

    monkeypatch.setattr(TrialOptimizer, "step", step)


def _half_batch(monkeypatch):
    from clip_gp_tpu_torch.parallel.trial_specs import AdapterSpec

    loss = AdapterSpec.loss

    def half(self, p, c, feats, labels, draw, hps):
        b = max(1, feats.shape[1] // 2)
        return loss(self, p, c, feats[:, :b], labels[:, :b], draw, hps)

    monkeypatch.setattr(AdapterSpec, "loss", half)


def _sweep_answer(monkeypatch):
    from clip_gp_tpu_torch.parallel import trial_vmap

    accuracy = trial_vmap.compute_accuracy
    monkeypatch.setattr(trial_vmap, "compute_accuracy",
                        lambda logits, labels: [accuracy(logits, labels)[0] + 5.0])


def _predict_answer(monkeypatch):
    from clip_gp_tpu_torch.methods.adapter import Trainer as AdapterTrainer

    logits = AdapterTrainer.predict_logits

    def altered(self, features):
        out = logits(self, features)
        out[:, 0] += 1.0
        return out

    monkeypatch.setattr(AdapterTrainer, "predict_logits", altered)


def _predict_half_batch(monkeypatch):
    from clip_gp_tpu_torch.methods import common

    extract = common.extract_with

    def half(encode, loader):
        feats, labels = extract(encode, loader)
        feats[len(feats) // 2:] = feats[: len(feats) - len(feats) // 2]
        return feats, labels

    monkeypatch.setattr(common, "extract_with", half)


FAULTS = [("rn50.gp_sweep", _unchanged_state), ("rn50.gp_sweep", _half_batch),
          ("rn50.gp_sweep", _sweep_answer), ("vit_b16.predict", _predict_answer),
          ("vit_b16.predict", _predict_half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    rc, line = small.run(cell)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


def test_the_sweep_runs_its_entry_with_decode_ahead_and_its_own_draws():
    import io
    from contextlib import redirect_stdout

    from port_bench import run as runner

    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.execute(small.context("rn50.gp_sweep"))
    assert rc == 0
    text = out.getvalue()
    assert "[vmap] decode-ahead: prefetching group 2/2" in text
    # 2 seeds x 4 grid cells in the warm-up's group and in each of the window's two
    assert text.count("[vmap] OK method=Adapter") == 3 * 2 * 4
    assert json.loads(text.strip().splitlines()[-1])["correct"] is True


def test_the_reference_replays_the_programs_gp_draws():
    from clip_gp_tpu_torch.parallel.trial_vmap import TrialDraws

    seeds = [7, 7, 3000000001, 2 ** 40 + 5]
    program = TrialDraws(seeds, torch.device("cpu"))
    mine = harness.driver("gp_sweep").Streams(seeds, torch.device("cpu"))
    for kind, index, shape in (("zero_shot", 0, (5, 3, 2)), ("train", 0, (4, 3, 2)),
                               ("train", 1, (4, 3, 2)), ("eval", 0, (5, 3, 2))):
        assert torch.equal(program(kind, index, shape), mine(shape))


def test_an_unreadable_program_state_is_an_error_of_the_benchmark(monkeypatch):
    drv = harness.driver("gp_sweep")

    def unreadable(self, runner, kind, index):
        raise AttributeError("'VmappedTrials' object has no attribute '_parts'")

    monkeypatch.setattr(drv.Capture, "_read", unreadable)
    monkeypatch.setattr(harness, "driver", lambda kind: drv)
    rc, line = small.run("rn50.gp_sweep")
    assert rc == 4 and line is None
