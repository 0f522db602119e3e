"""The port's bench and profile scripts (``clip_gp_tpu_torch.scripts``) at a
tiny size on the CPU: each module's ``run(...)`` returns a report with the
JAX script's keys (listed here, with ``backend`` become ``device``) and
writes only its own artifact, under ``build/scripts/``; each module's
``run`` defaults are the JAX script's sizes; ``bench_fused_vjp``'s two modes
give the same loss and context gradients within 1e-4 of the largest.

The sizes: TEST-ViT/TEST-RN towers, 2–3 classes, one epoch or step, a few
32-px images, two seeds where a group needs several.
"""

import inspect

import pytest

from clip_gp_tpu_torch.scripts import (
    _common,
    bench_backbones,
    bench_cocoop,
    bench_cocoop_imagenet_scale,
    bench_cocoop_profile,
    bench_cocoop_vmap,
    bench_coop_vmap,
    bench_fused_vjp,
    bench_gp,
    bench_int8_encode,
    bench_sweep,
    bench_sweep_methods,
    bench_sweep_projection,
    bench_trial,
    profile_vmap_group,
)

TINY = dict(backbone="TEST-ViT", image_size=32, workers=1)
GROUP = dict(TINY, seeds=[1, 2], classes=3, shots=2, images_per_class=6,
             epochs=1, n_ctx=2)
COCOOP_KEYS = {"metric", "seeds", "classes", "epochs", "vmapped_group_s",
               "vmapped_group_warm_s", "inprocess_trial_cold_s",
               "inprocess_trial_warm_s", "inprocess_group_s", "speedup",
               "speedup_warm", "baseline_note", "device"}
CELLS = {
    "bench_backbones": (
        lambda: bench_backbones.run(["TEST-ViT", "TEST-RN"], [2], timed_iters=1),
        {"metric", "unit", "device", "batches", "table", "dtype"}, None),
    "bench_int8_encode": (
        lambda: bench_int8_encode.run(2, 1, 1, ["TEST-ViT"]),
        {"batch", "device", "testvit_bf16_imgs_per_sec",
         "testvit_int8_imgs_per_sec", "testvit_speedup", "testvit_min_cosine"},
        None),
    "bench_gp": (
        lambda: bench_gp.run(4, 3, 16, 12, 10, 2, 3, 1, 1, 8),
        {"gp_train_step_ms", "gp_fit_1_epochs_s", "gp_mc_eval_s3_ms", "shape",
         "device", "final_loss"}, None),
    "bench_trial": (
        lambda: bench_trial.run(3, 6, 32, 2, "TEST-ViT", 1, workers=1),
        {"total_trial_s", "dataset_gen_s", "phases", "n_train", "n_test",
         "num_classes", "final_acc", "backbone", "epochs", "device"}, None),
    "profile_vmap_group": (
        lambda: profile_vmap_group.run(2, 3, 6, 1, **TINY),
        {"runs", "shots", "classes", "epochs", "seeds", "backbone", "device"},
        None),
    "bench_sweep": (
        lambda: bench_sweep.run(3, 6, 32, 2, "TEST-ViT", 1, workers=1),
        {"sweep_cell_trials", "sweep_cell_s", "s_per_trial", "dataset_gen_s",
         "epochs", "backbone", "accs", "device"}, None),
    "bench_coop_vmap": (
        lambda: bench_coop_vmap.run(**GROUP), COCOOP_KEYS, None),
    "bench_cocoop_vmap": (
        lambda: bench_cocoop_vmap.run(**GROUP),
        COCOOP_KEYS | {"shots", "microbatch_images", "prompt_tower_dtype"},
        "BENCH_cocoop_vmap.json"),
    "bench_cocoop": (
        lambda: bench_cocoop.run(3, 4, 1, "TEST-ViT"),
        {"cocoop_step_ms_default_budget256", "cocoop_step_ms_fully_batched",
         "batched_over_default_ratio", "shape", "device"}, None),
    "bench_cocoop_profile": (
        lambda: bench_cocoop_profile.run(3, 4, 1, 8, "TEST-ViT"),
        {"shape", "device", "fp32", "bf16", "bf16_step_speedup"},
        "BENCH_cocoop_profile.json"),
    "bench_fused_vjp": (
        lambda: bench_fused_vjp.run(2, 3, 2, 1, 1, "TEST-ViT", 4, 16),
        {"metric", "backbone", "trials", "classes", "n_ctx", "batch",
         "prompts_per_step", "kernels_ms", "library_ms", "speedup_vs_library",
         "xla_vjp_ms", "xla_vjp_note", "loss_kernels", "loss_library",
         "grad_max_rel_err", "protocol", "device"}, None),
    "bench_sweep_methods": (
        lambda: bench_sweep_methods.run(
            [1, 2], [1], 1, 1, "TEST-ViT", {"eurosat": 3}, {"eurosat": 3},
            smoke=True, workers=1),
        {"metric", "seeds", "epochs", "prompt_epochs", "shots_measured",
         "trials_run", "trials_per_s", "measured_total_s", "group_s_by_cell",
         "config3_projection_min", "config3_projection_note",
         "zero_vmap_fallbacks", "backbone", "device", "dataset_gen_s", "smoke",
         "config4_projection_min", "config4_projection_note"},
        "BENCH_sweep_methods.partial.json"),
    "bench_cocoop_imagenet_scale": (
        lambda: bench_cocoop_imagenet_scale.run([1, 2], 3, **TINY),
        {"metric", "value", "unit", "seeds", "classes", "prompt_len", "shots",
         "epochs", "batch_size", "step_prompt_encodes", "microbatch_images",
         "grad_dispatches_per_step", "peak_device_memory_gib", "dataset_gen_s",
         "device", "note"},
        "BENCH_cocoop_imagenet_scale.json"),
    "bench_sweep_projection": (
        lambda: bench_sweep_projection.run(
            (1, 2), (1, 2), classes=3, images_per_class=6, epochs=1, **TINY),
        {"metric", "trials_total", "measured_group_s_by_shots",
         "measured_per_dataset_s", "cold_first_dataset_s", "cards",
         "single_card_projection_min", "cards_projection_min", "target_min",
         "meets_target", "meets_target_single_card", "dataset_gen_s", "device",
         "measured_keys", "projected_keys", "assumptions",
         "measured_per_dataset_decode_ahead_s", "decode_ahead_group_s_by_shots",
         "decode_ahead_speedup"},
        "BENCH_sweep.json"),
}
# the JAX scripts' sizes, which each run(...) takes as its defaults
# (scripts/<name>.py's module constants and flags)
DEFAULTS = {
    bench_backbones.run: dict(
        backbones=("ViT-B/16", "ViT-B/32", "RN50", "RN101", "RN50x4", "RN50x16"),
        batches=(128, 256, 512), timed_iters=10),
    bench_int8_encode.run: dict(batch=256, timed_iters=20, windows=3,
                                archs=("ViT-B/16", "ViT-B/32")),
    bench_gp.run: dict(k=100, m=8, d=1024, n_train=1600, n_test=2465,
                       s_train=30, s_eval=300, epochs=100, timed_steps=20,
                       pca_dim=256),
    bench_trial.run: dict(num_classes=100, images_per_class=36, image_size=224,
                          shots=16, backbone="ViT-B/16", epochs=100),
    profile_vmap_group.run: dict(shots=4, classes=100, images_per_class=42,
                                 epochs=100, repeat=1),
    bench_sweep.run: dict(num_classes=100, images_per_class=36, shots=16,
                          epochs=100),
    bench_coop_vmap.run: dict(epochs=6, classes=50, seeds=[1, 2, 3, 4, 5],
                              shots=16, images_per_class=36, n_ctx=16),
    bench_cocoop_vmap.run: dict(epochs=3, classes=50, shots=16, n_ctx=4),
    bench_cocoop.run: dict(k=100, b=32, steps=10),
    bench_cocoop_profile.run: dict(k=100, b=32, steps=10, eval_rows=512),
    bench_fused_vjp.run: dict(t=5, k=100, n_ctx=16, steps=20, reps=3,
                              backbone="ViT-B/16", batch=32, context=77),
    bench_sweep_methods.run: dict(seeds=[1, 2, 3, 4, 5], shots=[16], epochs=10,
                                  prompt_epochs=2, backbone="ViT-B/16"),
    bench_cocoop_imagenet_scale.run: dict(seeds=[1, 2, 3, 4, 5], classes=1000,
                                          shots=1, epochs=1),
    bench_sweep_projection.run: dict(shots=(1, 2, 4, 8, 16), seeds=(1, 2, 3, 4, 5),
                                     classes=100, images_per_class=42, epochs=100,
                                     decode_ahead=True, pipelined=False),
}


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """Artifacts under tmp/build/scripts, the working directory tmp/cwd."""
    out = tmp_path / "build" / "scripts"
    monkeypatch.setattr(_common, "ARTIFACTS", out)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    return tmp_path


@pytest.mark.parametrize("name", sorted(CELLS))
def test_bench_report_keys_and_artifacts(name, artifacts):
    make, keys, artifact = CELLS[name]
    report = make()
    assert set(report) == keys
    assert report["device"] == "cpu"
    written = sorted(p.relative_to(artifacts).as_posix()
                     for p in artifacts.rglob("*") if p.is_file())
    assert written == ([f"build/scripts/{artifact}"] if artifact else [])


def test_artifacts_default_to_build_scripts():
    assert _common.ARTIFACTS == _common.REPO / "build" / "scripts"


@pytest.mark.parametrize("run", list(DEFAULTS), ids=lambda f: f.__module__.split(".")[-1])
def test_run_defaults_are_the_jax_sizes(run):
    params = inspect.signature(run).parameters
    for key, value in DEFAULTS[run].items():
        assert params[key].default == value, key


def test_fused_vjp_modes_agree(artifacts):
    report = bench_fused_vjp.run(2, 3, 2, 1, 1, "TEST-ViT", 4, 16)
    assert report["loss_kernels"] == pytest.approx(report["loss_library"], rel=1e-5)
    assert report["grad_max_rel_err"] <= 1e-4
