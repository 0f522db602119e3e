"""The port's checkpoint reload and serving path against the JAX package's,
end to end on the CPU.

Run directories are written by the JAX CLI (``train.py``) on TEST-ViT and the
Synthetic dataset from one ``MODEL.INIT_WEIGHTS`` npz, with no augmentation
and checkpoints on, once per module. The port then reloads them:

- ``--eval-only`` (``clip_gp_tpu_torch.train``) and the predict entry
  (``clip_gp_tpu_torch.predict``, ``--images`` and ``--split test``) give
  the JAX package's results on the deterministic configs (the Adapter
  without the GP, CoOp with ``--ctx-init``, and a reloaded CoCoOp, whose
  evaluation draws nothing): equal top-1, metrics within
  1e-3 (percentage points) and probabilities within 1e-4, since the towers
  agree at 5e-5.
- ``--int8``: the JAX side runs its fused Pallas int8 tower in interpret
  mode (``use_flash`` patched, as ``tests/test_torch_clip_model.py`` does)
  and op by op, the port its plain K5/K6. The two quantize alike but sum
  some fp32 terms in other orders, so probabilities agree within 2e-3 and
  top-1 is equal wherever JAX's top-2 margin exceeds 1e-2.
- ``--resume`` continues the JAX run from its saved epoch to the same
  checkpoint (state within 1e-5), ``FINAL_MODEL best_val`` writes and
  redeploys ``model-best.npz``, and a reload on a subset of the classes
  selects the rows JAX's remap selects.
"""

import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
for path in (REPO, REPO / "scripts"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import clip_gp_tpu.data.datasets  # noqa: E402,F401
import clip_gp_tpu.methods  # noqa: E402,F401
import clip_gp_tpu.ops.flash_attention as jfa  # noqa: E402
import clip_gp_tpu_torch.data.datasets  # noqa: E402,F401
import clip_gp_tpu_torch.methods  # noqa: E402,F401
import train as jax_cli  # noqa: E402
from clip_gp_tpu.core.logging import reset_tee as jax_reset_tee  # noqa: E402
from clip_gp_tpu.models.clip_loader import _flatten as jax_flatten  # noqa: E402
from clip_gp_tpu.models.clip_loader import _unflatten as jax_unflatten  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu_torch import predict as port_predict  # noqa: E402
from clip_gp_tpu_torch import train as port_cli  # noqa: E402
from clip_gp_tpu_torch.core.config import config_from_dict  # noqa: E402
from clip_gp_tpu_torch.core.logging import reset_tee as port_reset_tee  # noqa: E402
from clip_gp_tpu_torch.core.registry import build_trainer  # noqa: E402
from clip_gp_tpu_torch.core.seeding import set_random_seed  # noqa: E402
from clip_gp_tpu_torch.data.pipeline import build_data_manager  # noqa: E402
from clip_gp_tpu_torch.runtime import checkpoint as port_ckpt  # noqa: E402
from clip_gp_tpu_torch.runtime import trainer_base as port_tb  # noqa: E402

jax_predict = importlib.import_module("predict")

RUNS = {  # name → (flags, OPTS) of the JAX training run
    "adapter": ([], []),
    "coop": (["--trainer", "Adapter-CoOp", "--ctx-init", "a photo of a"], []),
    "cocoop": (["--trainer", "Adapter-CoCoOp", "--n-ctx", "2"], []),
    "gp": (["--use-gp"], ["TRAINER.ADAPTER.GP_PCA_DIM", "8",
                          "TRAINER.ADAPTER.GP_NUM_MC_SAMPLES_TRAIN", "4",
                          "TRAINER.ADAPTER.GP_NUM_MC_SAMPLES_EVAL", "8"]),
}


def _argv(root, out, weights, run, epochs=2, extra=()):
    flags, opts = RUNS[run]
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "2", *flags, *extra, *opts,
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "MODEL.INIT_WEIGHTS", str(weights),
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", str(epochs),
        "DATALOADER.NUM_WORKERS", "0", "TRAIN.PRINT_FREQ", "100",
        "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
    ]


def _run(cli, reset, argv):
    try:
        return cli.main(argv)
    finally:
        reset()


def _metrics(out):
    with (Path(out) / "metrics.json").open() as f:
        return json.load(f)["metrics"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("serving")
    weights = base / "test_vit.npz"
    save_params_npz(str(weights), ARCHITECTURES["TEST-ViT"],
                    init_clip_params(jax.random.key(0), ARCHITECTURES["TEST-ViT"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        for run in RUNS:
            _run(jax_cli, jax_reset_tee,
                 _argv(base / "data", base / f"jax-{run}", weights, run,
                       epochs=1 if run == "cocoop" else 2))
        yield {"base": base, "weights": weights, "mp": mp}


def _eval_only(env, side, run, name, opts=()):
    out = env["base"] / f"eval-{side}-{name}"
    cli, reset = (jax_cli, jax_reset_tee) if side == "jax" else (port_cli, port_reset_tee)
    _run(cli, reset, _argv(env["base"] / "data", out, env["weights"], run,
                           extra=["--eval-only", "--model-dir",
                                  str(env["base"] / f"jax-{run}")]) + list(opts))
    return _metrics(out)


def _predict(env, side, run, name, args):
    out = env["base"] / f"pred-{side}-{name}.json"
    main = jax_predict.main if side == "jax" else port_predict.main
    main(["--model-dir", str(env["base"] / f"jax-{run}"), "--output", str(out),
          "--topk", "4", *args])
    with out.open() as f:
        return json.load(f)


def _probs(payload):
    """[images, classes] probabilities and top-1 labels of a predictions.json."""
    k = payload["num_classes"]
    probs = np.zeros((payload["num_images"], k))
    for i, pred in enumerate(payload["predictions"]):
        for t in pred["topk"]:
            probs[i, t["label"]] = t["prob"]
    return probs, probs.argmax(1)


# CoCoOp trains from jax.random draws, but a reload fixes its parameters, so
# the reloaded run's evaluation is deterministic too
@pytest.mark.parametrize("run", ["adapter", "coop", "cocoop"])
def test_eval_only_matches_jax(env, run):
    expected = _eval_only(env, "jax", run, run)
    got = _eval_only(env, "port", run, run)
    assert got["top1_acc"] == expected["top1_acc"]
    for key in ("macro_f1", "ece", "aece"):
        assert got[key] == pytest.approx(expected[key], abs=1e-3), key


PREDICT_CASES = {
    "adapter-images": ("adapter", "images"),
    "adapter-split": ("adapter", "split"),
    "coop-split": ("coop", "split"),
}


@pytest.mark.parametrize("case", list(PREDICT_CASES))
def test_predict_matches_jax(env, case):
    run, source = PREDICT_CASES[case]
    args = (["--images", str(env["base"] / "data" / "synthetic" / "images")]
            if source == "images" else ["--split", "test"])
    expected = _predict(env, "jax", run, case, args)
    got = _predict(env, "port", run, case, args)
    assert {k for k in got if k != "elapsed_s"} == {k for k in expected if k != "elapsed_s"}
    assert [p["path"] for p in got["predictions"]] == [
        p["path"] for p in expected["predictions"]]
    got_p, got_top = _probs(got)
    exp_p, exp_top = _probs(expected)
    np.testing.assert_array_equal(got_top, exp_top)
    np.testing.assert_allclose(got_p, exp_p, rtol=0, atol=1e-4)
    if source == "split":
        assert got["summary"]["top1_acc"] == expected["summary"]["top1_acc"]
        for key in ("ece", "aece"):
            assert got["summary"][key] == pytest.approx(expected["summary"][key],
                                                         abs=1e-3)


def test_int8_predict_matches_the_jax_pallas_tower(env, monkeypatch):
    monkeypatch.setattr(jfa, "use_flash", lambda: True)
    # one device: the interpreted Pallas kernels do not run under the
    # sharded extraction the JAX trainer picks on the test's 8 CPU devices
    monkeypatch.setenv("CLIP_GP_TPU_SHARD_EXTRACTION", "0")
    # three images of each class (the JAX side runs op by op, slowly)
    images = env["base"] / "int8-images"
    for src in sorted((env["base"] / "data" / "synthetic" / "images").rglob("*.png")):
        if int(src.stem.split("_")[-1]) < 3:
            (images / src.parent.name).mkdir(parents=True, exist_ok=True)
            (images / src.parent.name / src.name).write_bytes(src.read_bytes())
    args = ["--images", str(images), "--int8"]
    # op by op: under jit XLA fuses the bf16 stem's casts, which moves the
    # JAX features off its own eager tower (cosine 0.99995 on these images);
    # the port's plain tower follows the eager one
    with jax.disable_jit():
        expected = _predict(env, "jax", "adapter", "int8", args)
    got = _predict(env, "port", "adapter", "int8", args)
    got_p, got_top = _probs(got)
    exp_p, exp_top = _probs(expected)
    np.testing.assert_allclose(got_p, exp_p, rtol=0, atol=2e-3)
    top2 = np.sort(exp_p, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    assert clear.any()
    np.testing.assert_array_equal(got_top[clear], exp_top[clear])
    # the int8 features are not the fp32 ones
    fp32 = _predict(env, "port", "adapter", "fp32", ["--images", str(images)])
    assert np.abs(_probs(fp32)[0] - got_p).max() > 0


def test_int8_eval_only_serves_the_int8_tower(env):
    """``--eval-only`` with MODEL.INT8_INFERENCE encodes the test split through
    the int8 tower: its metrics are those of the predict entry's int8 run."""
    got = _eval_only(env, "port", "adapter", "int8", ["MODEL.INT8_INFERENCE", "True"])
    summary = _predict(env, "port", "adapter", "int8-check",
                       ["--split", "test", "--int8"])["summary"]
    assert got["top1_acc"] == pytest.approx(summary["top1_acc"], abs=1e-3)
    assert got["ece"] == pytest.approx(summary["ece"], abs=1e-3)


def test_resume_continues_from_the_saved_epoch(env):
    base = env["base"]
    extra = ["--resume", str(base / "jax-adapter")]
    outs = {}
    for side, cli, reset in (("jax", jax_cli, jax_reset_tee),
                             ("port", port_cli, port_reset_tee)):
        outs[side] = base / f"resume-{side}"
        _run(cli, reset, _argv(base / "data", outs[side], env["weights"],
                               "adapter", epochs=3, extra=extra))
    log = (outs["port"] / "log.txt").read_text()
    assert "Loading checkpoint from" in log and "model.ckpt-2.npz" in log
    names = sorted(p.name for p in (outs["port"] / "adapter").glob("*.npz"))
    assert names == sorted(p.name for p in (outs["jax"] / "adapter").glob("*.npz"))
    assert names == ["model.ckpt-3.npz"]
    with np.load(outs["jax"] / "adapter" / names[0]) as a, \
            np.load(outs["port"] / "adapter" / names[0]) as b:
        assert int(b["__epoch__"]) == 3
        for key in a.files:
            if key.startswith("state/"):
                np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-5,
                                           err_msg=key)


def test_best_val_writes_and_redeploys_model_best(env):
    base = env["base"]
    out = base / "port-best"
    _run(port_cli, port_reset_tee,
         _argv(base / "data", out, env["weights"], "adapter", epochs=3)
         + ["FINAL_MODEL", "best_val"])
    log = (out / "log.txt").read_text()
    assert "New best val accuracy" in log
    assert "Deploy the model with the best val performance" in log
    best = out / "adapter" / "model-best.npz"
    assert best.exists()
    assert port_tb.resolve_checkpoint_path(str(out)) == best
    deployed = _metrics(out)
    # the deployed model is the best one: an eval-only reload of the run
    # gives the same test metrics
    evald = base / "port-best-eval"
    _run(port_cli, port_reset_tee,
         _argv(base / "data", evald, env["weights"], "adapter",
               extra=["--eval-only", "--model-dir", str(out)]))
    assert _metrics(evald)["top1_acc"] == deployed["top1_acc"]
    assert _metrics(evald)["ece"] == pytest.approx(deployed["ece"], abs=1e-6)


def _subset_trainer(env, run, subsample="base"):
    with (env["base"] / f"jax-{run}" / "config.json").open() as f:
        config = config_from_dict(json.load(f))
    config.dataset.subsample_classes = subsample
    config.output_dir = str(env["base"] / f"subset-{run}-{subsample}")
    set_random_seed(config.seed)
    trainer = build_trainer(config, build_data_manager(config))
    trainer.build_model()
    return trainer


def _jax_subset_trainer(env, run, subsample="base"):
    from clip_gp_tpu.core.config import config_from_dict as jax_config_from_dict
    from clip_gp_tpu.core.registry import build_trainer as jax_build_trainer
    from clip_gp_tpu.core.seeding import set_random_seed as jax_seed
    from clip_gp_tpu.data.pipeline import build_data_manager as jax_dm

    with (env["base"] / f"jax-{run}" / "config.json").open() as f:
        config = jax_config_from_dict(json.load(f))
    config.dataset.subsample_classes = subsample
    jax_seed(config.seed)
    trainer = jax_build_trainer(config, jax_dm(config))
    trainer.build_model()
    return trainer


@pytest.mark.parametrize("run", ["adapter", "gp", "coop"])
def test_class_subset_remap_matches_jax(env, run):
    model_dir = str(env["base"] / f"jax-{run}")
    trainer = _subset_trainer(env, run)
    ref = _jax_subset_trainer(env, run)
    assert trainer.load_model(model_dir) == ref.load_model(model_dir) == 2
    assert len(trainer.dm.dataset.classnames) == 2
    got = port_ckpt._flatten(trainer.params)
    expected = {k: np.asarray(v) for k, v in jax_flatten(ref.params).items()}
    assert set(got) == set(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    if run == "gp":
        assert trainer.gp_static.num_classes == ref.gp_static.num_classes == 2
        for key, value in ref.gp_buffers.items():
            np.testing.assert_array_equal(trainer.gp_buffers[key].numpy(),
                                          np.asarray(value), err_msg=key)
    with torch.no_grad():
        trainer.predict_logits(torch.zeros(3, 32))  # the head runs on K=2


def test_remap_guards(env, tmp_path):
    trainer = _subset_trainer(env, "adapter", subsample="new")
    # the new half was trained too: a reload on it works; remove a class
    # from the checkpoint's vocabulary and it must refuse
    path = port_tb.resolve_checkpoint_path(str(env["base"] / "jax-adapter"))
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    names = list(arrays["__classnames__"])
    model_dir = tmp_path / "run"
    (model_dir / "adapter").mkdir(parents=True)
    missing = dict(arrays, __classnames__=np.asarray(
        [names[0]] * 2 + names[2:3] + ["other"], dtype=np.str_))
    np.savez(model_dir / "adapter" / "model.ckpt-2.npz", **missing)
    with pytest.raises(ValueError, match="missing"):
        trainer.load_model(str(model_dir))
    dup = dict(arrays, __classnames__=np.asarray(
        [names[2], names[1], names[2], names[3]], dtype=np.str_))
    np.savez(model_dir / "adapter" / "model.ckpt-2.npz", **dup)
    with pytest.raises(ValueError, match="more than once"):
        trainer.load_model(str(model_dir))


def test_checkpoint_discovery_and_reference_format(tmp_path):
    adapter = tmp_path / "adapter"
    adapter.mkdir()
    assert port_tb.resolve_checkpoint_path(str(tmp_path)) is None
    for epoch in (2, 10):
        np.savez(adapter / f"model.ckpt-{epoch}.npz", __epoch__=np.asarray(epoch))
    assert port_tb.resolve_checkpoint_path(str(tmp_path)).name == "model.ckpt-10.npz"
    assert port_tb.resolve_checkpoint_path(str(tmp_path), 2).name == "model.ckpt-2.npz"
    assert port_tb.resolve_checkpoint_path(str(tmp_path), 3) is None
    np.savez(adapter / "model-best.npz", __epoch__=np.asarray(1))
    assert port_tb.resolve_checkpoint_path(str(tmp_path)).name == "model-best.npz"

    ref_dir = tmp_path / "ref"
    (ref_dir / "adapter").mkdir(parents=True)
    trainer = port_tb.BaseTrainer.__new__(port_tb.BaseTrainer)
    assert trainer.load_model(str(ref_dir)) == 0
    # a reference-format checkpoint is converted and adopted
    # (tests/test_torch_ref_checkpoint.py holds every converter against JAX)
    torch.save({"state_dict": {"prompt_learner.ctx": torch.ones(2, 4)}, "epoch": 5},
               ref_dir / "adapter" / "model.pth.tar-5")
    trainer.config = SimpleNamespace(trainer_name="Adapter-CoOp")
    loaded = []
    trainer.load_trainable_state = loaded.append
    assert trainer.load_model(str(ref_dir)) == 5
    np.testing.assert_array_equal(loaded[0]["ctx"], np.ones((2, 4), np.float32))


def test_unflatten_matches_jax():
    tree = {"state": {"a": np.ones((2, 3), np.float32),
                      "gp": {"x": np.zeros(4, np.float32)},
                      "lst": [np.arange(2.0), np.arange(3.0)]}}
    flat = port_ckpt._flatten(tree)
    assert flat.keys() == jax_flatten(tree).keys()
    got, expected = port_ckpt._unflatten(flat), jax_unflatten(flat)
    assert isinstance(got["state"]["lst"], list)
    np.testing.assert_array_equal(got["state"]["lst"][1], np.asarray(expected["state"]["lst"][1]))
    np.testing.assert_array_equal(got["state"]["gp"]["x"], np.asarray(expected["state"]["gp"]["x"]))


def test_int8_plan_is_built_once_per_loaded_tower(env):
    trainer = _subset_trainer(env, "adapter", subsample="all")
    trainer.config.model.int8_inference = True
    plan = trainer._encode_plan()
    assert plan["int8"] and trainer._encode_plan() is plan
    first = plan["qvisual"]["blocks"][0]["attn"]["w_qkv"]["q"]
    assert first.dtype == torch.int8
    trainer.load_clip_model()
    assert trainer._encode_plan()["qvisual"] is not plan["qvisual"]
