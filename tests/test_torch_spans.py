"""The port's span log (``runtime/profiling.py``), the spans the program opens
and the benchmark's readers of them (``port_bench/metrics/``):

- nesting, parent and root ids on two threads, the phase timers' report,
  the bounded log dropping its oldest span, and a span's interval on the
  profiler's clock around its range in a CPU trace;
- ``extract_with`` over a small ``BatchLoader``: one ``data.wait_batch`` and
  one ``data.decode_batch`` per batch, one ``tower.issue`` per device batch;
- a two-group decode-ahead sweep: one ``vmap.group`` per group with its
  seeds and shots, one ``vmap.step`` per step, and the second group's
  ``vmap.prefetch`` on the producer thread;
- each span metric of the benchmark on a synthetic record and span log,
  against its value worked out by hand, and None where its spans are
  missing or were dropped.
"""

import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
for path in (TESTS, ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from test_torch_prefetch import _sweep  # noqa: E402
import clip_gp_tpu_torch.parallel.trial_vmap as ttv  # noqa: E402
from clip_gp_tpu_torch.data.datum import Datum  # noqa: E402
from clip_gp_tpu_torch.data.pipeline import BatchLoader  # noqa: E402
from clip_gp_tpu_torch.methods.common import extract_with  # noqa: E402
from clip_gp_tpu_torch.runtime import profiling  # noqa: E402
from port_bench import harness  # noqa: E402

WAIT_S = 30.0


@pytest.fixture(autouse=True)
def fresh_log():
    profiling.reset_phases()
    yield
    profiling.reset_phases()


def _by_name(name):
    return [s for s in profiling.spans() if s.name == name]


def test_spans_nest_and_share_their_root_per_thread():
    def worker():
        with profiling.span("c", job=2):
            with profiling.span("d"):
                pass

    with profiling.span("a", group=1) as a:
        with profiling.span("b") as b:
            b.attrs["images"] = 3
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(WAIT_S)
        assert not thread.is_alive()
    log = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == ["b", "d", "c", "a"]  # as they ended
    assert log["a"].parent is None and log["a"].root == log["a"].id
    assert log["b"].parent == log["a"].id and log["b"].root == log["a"].id
    assert log["c"].parent is None and log["c"].root == log["c"].id
    assert log["d"].parent == log["c"].id and log["d"].root == log["c"].id
    assert log["a"].thread == log["b"].thread != log["c"].thread == log["d"].thread
    assert log["a"].attrs == {"group": 1} and log["b"].attrs == {"images": 3}
    assert log["c"].attrs == {"job": 2}
    assert log["a"].start_ns <= log["b"].start_ns <= log["b"].end_ns <= log["a"].end_ns
    assert len({s.id for s in log.values()}) == 4


def test_phase_timer_is_a_span_and_keeps_the_report():
    for _ in range(2):
        with profiling.phase_timer("alpha"):
            time.sleep(0.005)
    with profiling.phase_timer("beta", device="cpu"), profiling.span("inner"):
        pass
    report = profiling.phase_report()
    assert set(report) == {"alpha", "beta"}  # a plain span adds no phase
    assert report["alpha"]["count"] == 2 and report["beta"]["count"] == 1
    for name in ("alpha", "beta"):
        logged = sum(s.end_ns - s.start_ns for s in _by_name(name)) / 1e9
        assert report[name]["total_s"] == pytest.approx(logged)
    assert _by_name("inner")[0].parent == _by_name("beta")[0].id
    profiling.reset_phases()
    assert profiling.phase_report() == {} and profiling.spans() == []


def test_the_bounded_log_drops_its_oldest_spans():
    extra = 3
    for i in range(profiling.LOG_SIZE + extra):
        with profiling.span("s", i=i):
            pass
    log = profiling.spans()
    assert len(log) == profiling.LOG_SIZE and profiling.dropped() == extra
    assert log[0].attrs["i"] == extra and log[-1].attrs["i"] == profiling.LOG_SIZE + extra - 1
    profiling.reset_phases()
    assert profiling.dropped() == 0 and profiling.spans() == []


def test_a_span_lies_around_its_range_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clocked"):
            torch.ones(64).sum()
            time.sleep(0.003)
    (s,) = _by_name("clocked")
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "clocked"]
    assert len(events) == 1
    start = events[0].start_ns()
    end = start + events[0].duration_ns()
    tolerance = 1_000_000  # 1 ms
    assert profiling.trace_ns(s.start_ns) - tolerance <= start
    assert end <= profiling.trace_ns(s.end_ns) + tolerance
    assert end - start >= 3_000_000


def test_extract_with_spans_each_batch(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_EXTRACT_DEVICE_BATCH", "8")
    rng = np.random.default_rng(0)
    source = []
    for i in range(20):
        path = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 255, (6, 6, 3), dtype=np.uint8)).save(path)
        source.append(Datum(impath=str(path), label=i % 4))

    class Plain:
        uses_rng = False

        def __call__(self, img, rng=None):
            return np.asarray(img, dtype=np.uint8)

    loader = BatchLoader(source, Plain(), 3, num_workers=2)
    feats, labels = extract_with(
        lambda imgs: torch.from_numpy(imgs).float().mean(dim=(1, 2)), loader)
    assert feats.shape == (20, 3) and list(labels) == [i % 4 for i in range(20)]
    waits, decodes = _by_name("data.wait_batch"), _by_name("data.decode_batch")
    issues, copies = _by_name("tower.issue"), _by_name("data.to_host")
    assert len(waits) == len(decodes) == len(loader) == 7
    assert [w.attrs["images"] for w in sorted(waits, key=lambda s: s.start_ns)] == [3] * 6 + [2]
    assert sum(d.attrs["images"] for d in decodes) == 20
    # the loader decodes on the thread that waits for it
    assert {d.parent for d in decodes} == {w.id for w in waits}
    assert [i.attrs["images"] for i in sorted(issues, key=lambda s: s.start_ns)] == [9, 9, 2]
    assert len(copies) == 1 and copies[0].start_ns >= max(i.end_ns for i in issues)


def test_decode_ahead_sweep_spans_each_group(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    steps = []
    real_step = ttv.VmappedTrials._step

    def counted(self, *args):
        steps.append(time.perf_counter_ns())
        return real_step(self, *args)

    monkeypatch.setattr(ttv.VmappedTrials, "_step", counted)
    _, out, made = _sweep(tmp_path, tmp_path / "out", monkeypatch, capsys, disable=False)
    assert "[vmap] decode-ahead: prefetching group 2/2" in out and len(made) == 1
    made[0]._thread.join(WAIT_S)
    assert not made[0]._thread.is_alive()
    groups = sorted(_by_name("vmap.group"), key=lambda s: s.start_ns)
    assert [(g.attrs["shots"], g.attrs["seeds"], g.attrs["trials"]) for g in groups] == [
        (1, [1, 2], 2), (2, [1, 2], 2)]
    assert {g.attrs["method"] for g in groups} == {"Adapter"}
    for g in groups:
        assert g.parent is None and g.root == g.id
        mine = [s for s in profiling.spans() if s.root == g.id]
        assert {"vmap.union_encode", "vmap.train.step", "data.wait_batch"} <= {
            s.name for s in mine}
        step_spans = sorted((s for s in mine if s.name == "vmap.step"), key=lambda s: s.start_ns)
        inside = [t for t in steps if g.start_ns <= t <= g.end_ns]
        assert len(step_spans) == len(inside) > 0
        assert [s.attrs["step"] for s in step_spans] == list(range(len(inside)))
    (prefetch,) = _by_name("vmap.prefetch")
    assert prefetch.attrs == {"seeds": [1, 2], "shots": 2}
    assert prefetch.parent is None and prefetch.thread == made[0]._thread.ident
    assert prefetch.thread != groups[1].thread
    decoded = [s for s in profiling.spans() if s.root == prefetch.id != s.id]
    assert decoded and {s.name for s in decoded} == {"data.decode_batch"}


# ----------------------------------------------------------------------
# the benchmark's readers, on a synthetic log (times in ms, as ns)
# ----------------------------------------------------------------------

MS = 1_000_000


def _span(sid, name, a, b, parent=None, root=None, thread=1, **attrs):
    return profiling.Span(sid, name, thread, a * MS, b * MS, parent,
                          root if root is not None else sid, attrs)


def _summary(a, b, device):
    busy = sum(e - s for s, e in device)
    return {"window_s": (b - a) / 1e3, "busy_s": busy / 1e3,
            "device": [("kernel", s * MS, e * MS) for s, e in device]}


def _sweep_log():
    return [
        _span(1, "vmap.group", 0, 50, seeds=[9], shots=4),  # the warm-up's
        _span(2, "vmap.group", 100, 1100, seeds=[1, 2], shots=4),
        _span(3, "vmap.union_encode", 200, 500, 2, 2),
        _span(4, "data.wait_batch", 210, 250, 3, 2, images=8),
        _span(5, "data.wait_batch", 300, 360, 3, 2, images=8),
        _span(6, "data.wait_batch", 600, 620, 2, 2),  # outside the union encode
        _span(7, "vmap.step", 700, 710, 2, 2, step=0),
        _span(8, "vmap.step", 720, 740, 2, 2, step=1),
        _span(9, "vmap.group", 2000, 3000, seeds=[3, 4], shots=4),
        _span(10, "vmap.union_encode", 2100, 2200, 9, 9),
        _span(11, "data.wait_batch", 2100, 2150, 10, 9),
        _span(12, "vmap.step", 2500, 2600, 9, 9, step=0),
        _span(13, "vmap.step", 2700, 2800, 9, 9, step=1),
        _span(14, "vmap.step", 2700, 2800, thread=2),  # another thread's
    ]


def _sweep_record(device="cuda"):
    traced = _summary(2000, 3000, [(2000, 2500), (2550, 2700), (2750, 2900)])
    return {"cell": SimpleNamespace(device=torch.device(device)),
            "groups": [{"seeds": [1, 2], "shots": 4, "trace": None},
                       {"seeds": [3, 4], "shots": 4, "trace": traced}]}


def _predict_log():
    return [
        _span(1, "feature_extraction", 0, 100),  # the warm-up job's
        _span(2, "feature_extraction", 1000, 1400),
        _span(3, "data.wait_batch", 1000, 1150, 2, 2),
        _span(4, "data.wait_batch", 1200, 1250, 2, 2),
        _span(5, "feature_extraction", 2000, 2300),
        _span(6, "data.wait_batch", 2000, 2100, 5, 5),
        _span(7, "feature_extraction", 3000, 3500),
        _span(8, "data.wait_batch", 3000, 3100, 7, 7),
        _span(9, "data.wait_batch", 3200, 3300, 7, 7),
    ]


def _predict_record(device="cuda"):
    traced = _summary(1000, 1500, [(1100, 1200), (1250, 1400)])
    return {"cell": SimpleNamespace(device=torch.device(device)),
            "jobs": [{"seconds": 0.5, "trace": traced}, {"seconds": 0.4, "trace": None},
                     {"seconds": 0.6, "trace": None}]}


# (metric, log, record, by hand)
READINGS = [
    # the untraced group's two waits in its union encode, 40 + 60 ms
    ("union_decode_wait_s.sweep", _sweep_log, _sweep_record, 0.1),
    # the untraced group's steps, 10 and 20 ms
    ("gp_step_issue_ms.sweep", _sweep_log, _sweep_record, 15.0),
    # traced group: idle 200 ms of 1 s; inside its steps 50 + 50 ms
    ("idle_in_step_issue.sweep", _sweep_log, _sweep_record, 50.0),
    # the untraced jobs wait 100 + 200 ms of their 1.0 s
    ("decode_wait_share.predict", _predict_log, _predict_record, 30.0),
    # traced job: idle 250 ms of 500; inside its waits 150 - 50 + 50 ms
    ("idle_waiting_decode.predict", _predict_log, _predict_record, 60.0),
]


def _feed(monkeypatch, log, dropped=0):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    monkeypatch.setattr(profiling, "dropped", lambda: dropped)
    monkeypatch.setattr(profiling, "trace_ns", lambda t: t)


@pytest.mark.parametrize("metric,log,record,value", READINGS, ids=[r[0] for r in READINGS])
def test_span_metrics_read_by_hand(monkeypatch, metric, log, record, value):
    read = harness.reader(metric).read
    _feed(monkeypatch, log())
    assert read(record()) == pytest.approx(value)
    if metric.startswith("idle_"):
        assert read(record("cpu")) is None  # a device metric
    # no span log, or none of the spans the metric needs
    _feed(monkeypatch, [])
    assert read(record()) is None
    needed = {"union_decode_wait_s.sweep": "data.wait_batch", "gp_step_issue_ms.sweep": "vmap.step",
              "idle_in_step_issue.sweep": "vmap.step", "decode_wait_share.predict": "data.wait_batch",
              "idle_waiting_decode.predict": "data.wait_batch"}[metric]
    _feed(monkeypatch, [s for s in log() if s.name != needed])
    assert read(record()) is None
    # the log dropped its oldest spans, through one that ended inside the
    # last group or job (the log keeps spans in the order they ended)
    ordered = sorted(log(), key=lambda s: s.end_ns)
    last = max(s.start_ns for s in ordered if s.name in ("vmap.group", "feature_extraction"))
    k = 1 + next(i for i, s in enumerate(ordered) if s.end_ns > last)
    _feed(monkeypatch, ordered[k:], dropped=k)
    assert read(record()) is None
