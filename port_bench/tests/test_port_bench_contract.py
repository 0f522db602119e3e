"""The benchmark's files against its contract: names and units, every
cell's files found by name (and a mix or metric added as files only), the
imports of what runs on the card, and the operation counts by hand."""

import ast
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import flops, harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_lines():
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    names = [e["name"] for group in ("configs", "workloads") for e in BENCH[group]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e, layer = harness.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer and all(m["moves"] in {e["name"] for e in e2e} for m in layer)


def test_cell_files_are_found_by_name():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        harness.check_architecture(cfg)
    for w in BENCH["workloads"]:
        traffic = harness.load_json("traffic", w["traffic"])
        drv = harness.driver(traffic["kind"])
        assert callable(drv.run) and callable(drv.control)
        assert harness.load_json("limits", w["name"])
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_a_mix_and_a_metric_added_as_files_are_found(tmp_path, monkeypatch):
    copy = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((copy / "traffic" / "predict.json").read_text())
    mix["images"] = {**mix["images"], "images": 100}
    (copy / "traffic" / "predict_small.json").write_text(json.dumps(mix))
    (copy / "metrics" / "jobs.predict.py").write_text(
        "def read(record):\n    return float(len(record['jobs']))\n")
    monkeypatch.setattr(harness, "HERE", copy)
    assert harness.load_json("traffic", "predict_small")["images"]["images"] == 100
    assert harness.reader("jobs.predict").read({"jobs": [1, 2, 3]}) == 3.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_no_port():
    for path in (ROOT / "port_bench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))
    for path in (ROOT / "port_bench" / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "clip_gp_tpu_torch" not in tops, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "clip_gp_tpu_torch_like", sys)
    assert "clip_gp_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "clip_gp_tpu.ops", sys)
    assert "clip_gp_tpu.ops" in harness.forbidden_modules()


def test_operation_and_byte_counts_by_hand():
    # K1 at b=2, n=3, d=4: qkv 2*6*4*12, out 2*6*4*4, QK^T and PV 2 * 2*2*3*3*4
    assert flops.ln_attention_block(2, 3, 4) == (576 + 192 + 288, 4 * (2 * 24 + 64 + 16 + 8))
    # K2: c_fc 2*6*4*16 and c_proj 2*6*16*4
    assert flops.ln_mlp_block(2, 3, 4) == (768 + 768, 4 * (2 * 24 + 128 + 20 + 8))
    tiny = {"context_length": 3, "transformer_width": 4, "transformer_layers": 2, "embed_dim": 5}
    assert flops.text_flops(tiny) == 2 * ((576 + 192 + 288 + 1536) // 2) + 2 * 4 * 5
    vit = {"vision_patch_size": 2, "vision_width": 4, "image_resolution": 4,
           "vision_layers": 1, "embed_dim": 5}
    # 4 patches of 2x2x3 onto width 4, one block over 5 tokens, the projection
    assert flops.vit_flops(vit) == 2 * 4 * 12 * 4 + (24 * 5 * 16 + 4 * 25 * 4) + 2 * 4 * 5
    assert flops.gp_forward_flops(1, 2, 3, 4, 1, 5, 6) == (
        2 * 2 * 25 + 2 * 4 * (4 + 2 + 1) * 6 + 2 * 3 * 4 * 1 * 5 + 2 * 3 * 2 * 4 * 5)
    assert flops.bound_seconds(495e12, 0) == pytest.approx(1.0)
    assert flops.bound_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_resnet_count_by_hand():
    cfg = {"vision_width": 8, "image_resolution": 64, "vision_layers": [1, 1, 1, 1], "embed_dim": 32}
    stem = 2 * 32 * 32 * (3 * 4 * 9 + 4 * 4 * 9 + 4 * 8 * 9)
    # layer1 at 16x16 (8 -> 8 planes -> 32, downsample), then 32x32... halving
    l1 = 2 * 256 * (8 * 8 + 8 * 8 * 9 + 8 * 32 + 8 * 32)
    l2 = 2 * 256 * 32 * 16 + 2 * 256 * 16 * 16 * 9 + 2 * 64 * 16 * 64 + 2 * 64 * 32 * 64
    l3 = 2 * 64 * 64 * 32 + 2 * 64 * 32 * 32 * 9 + 2 * 16 * 32 * 128 + 2 * 16 * 64 * 128
    l4 = 2 * 16 * 128 * 64 + 2 * 16 * 64 * 64 * 9 + 2 * 4 * 64 * 256 + 2 * 4 * 128 * 256
    e, tokens = 256, 5
    pool = 2 * e * e + 2 * 2 * tokens * e * e + 4 * tokens * e + 2 * e * 32
    assert flops.resnet_flops(cfg) == stem + l1 + l2 + l3 + l4 + pool
