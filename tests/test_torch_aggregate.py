"""The port's aggregator and bar-plot tables (``clip_gp_tpu_torch.reporting``)
against the JAX package's on one run tree: the printed tables and every CSV
byte for byte, through each ``main`` and through the functions the JAX
suite drives. Also: ``--no-plots`` needs no matplotlib, and a plot request
without matplotlib raises a clear error."""

import json
import sys

import pytest

from clip_gp_tpu.reporting import aggregate as jagg
from clip_gp_tpu.reporting import bars as jbars
from clip_gp_tpu_torch.reporting import aggregate as tagg
from clip_gp_tpu_torch.reporting import bars as tbars

BINS = {"bin_acc": [0.1 * i for i in range(10)],
        "bin_conf": [0.05 + 0.1 * i for i in range(10)],
        "bin_count": [10] * 10}


def _write_tree(root):
    """Two experiments × two datasets × shots 1/4 × seeds 1/2, GP and CoOp
    families; one seed dir without metrics.json (pruned by --delete)."""
    for exp in ("expA", "expB"):
        for ds in ("caltech101", "eurosat"):
            for fam, bump in (("GP", 0.0), ("CoOp", 2.5)):
                for shots in (1, 4):
                    for seed in (1, 2):
                        d = root / exp / ds / f"{fam}_{shots}shots" / f"seed{seed}"
                        d.mkdir(parents=True, exist_ok=True)
                        acc = 55.0 + 3 * shots + seed + bump + (exp == "expB")
                        ece = 4.0 + seed / 3 + bump / 10
                        payload = {
                            "dataset": ds, "shots": shots, "seed": seed,
                            "method": fam.lower(), "backbone": "RN50",
                            "zero_shot": {"top1_acc": 50.0 + seed, "ece": 10.0,
                                          "aece": 9.5},
                            "metrics": {"top1_acc": acc, "ece": ece, "aece": ece + 1,
                                        "calibration": BINS},
                        }
                        (d / "metrics.json").write_text(json.dumps(payload))
    (root / "expA" / "eurosat" / "GP_1shots" / "seed3").mkdir(parents=True)


def _files(root, pattern):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.glob(pattern))}


@pytest.mark.parametrize("flags", [[], ["--grouped"], ["--show-zero-shot"],
                                   ["--ref-style", "--grouped"]],
                         ids=["default", "grouped", "zero-shot", "ref-style"])
def test_aggregate_main_matches_jax(tmp_path, capsys, flags):
    out = {}
    for side, mod in (("jax", jagg), ("port", tagg)):
        root = tmp_path / side
        _write_tree(root)
        capsys.readouterr()
        mod.main(["expA", "--output-root", str(root), *flags])
        # the printed paths name each side's own tree
        out[side] = (capsys.readouterr().out.replace(str(root), "<root>"),
                     _files(root / "expA", "_tables/*.csv"),
                     sorted(p.relative_to(root).as_posix()
                            for p in (root / "expA" / "_plots").rglob("*.png")))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1] and out["port"][1]
    assert out["port"][2] == out["jax"][2] and out["port"][2]


def test_aggregate_delete_and_functions_match_jax(tmp_path, capsys):
    tables = {}
    for side, mod in (("jax", jagg), ("port", tagg)):
        root = tmp_path / side
        _write_tree(root)
        runs = mod.load_runs(root / "expA", delete=True)
        grouped = mod.group_runs(runs)
        capsys.readouterr()
        mod.print_summary(grouped)
        mod.print_average_summary(grouped)
        mod.write_experiment_tables(grouped, "expA", root)
        tables[side] = (len(runs), capsys.readouterr().out.replace(str(root), "<root>"),
                        _files(root / "expA", "_tables/*.csv"),
                        (root / "expA" / "eurosat" / "GP_1shots" / "seed3").exists())
    assert tables["port"] == tables["jax"]
    assert tables["port"][3] is False  # the unfinished seed dir was pruned


def test_bars_main_matches_jax(tmp_path, capsys):
    outs = {}
    for side, mod in (("jax", jbars), ("port", tbars)):
        root = tmp_path / side
        _write_tree(root)
        assert mod.main(["expA", "expB", "--output-root", str(root),
                         "--outdir", str(root / "plots")]) == 0
        outs[side] = ((root / "runs.csv").read_bytes(),
                      sorted(p.name for p in (root / "plots").glob("*.png")))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == ["caltech101_all_metrics.png", "eurosat_all_metrics.png"]


def test_no_plots_needs_no_matplotlib(tmp_path, capsys, monkeypatch):
    root = tmp_path / "port"
    _write_tree(root)
    jroot = tmp_path / "jax"
    _write_tree(jroot)
    jagg.main(["expA", "--output-root", str(jroot)])
    capsys.readouterr()
    # matplotlib made unimportable: the tables and CSVs still come out
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tagg.main(["expA", "--output-root", str(root), "--no-plots"])
    assert "Average across datasets" in capsys.readouterr().out
    assert (_files(root / "expA", "_tables/*.csv")
            == _files(jroot / "expA", "_tables/*.csv"))
    assert not (root / "expA" / "_plots").exists()
    # ... and a plot request raises, naming the way out
    with pytest.raises(RuntimeError, match="--no-plots"):
        tagg.main(["expA", "--output-root", str(root)])
    with pytest.raises(RuntimeError, match="matplotlib"):
        tbars.main(["expA", "--output-root", str(root)])
