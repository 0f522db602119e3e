"""The port's OOD entry (``python -m clip_gp_tpu_torch.ood_eval``) against the
JAX package's ``scripts/ood_eval.py`` (BASELINE config #5).

One run is trained by the JAX package on the ImageNet fixture of
``tests/test_dataset_catalogs.py`` (TEST-ViT, the weights of one npz that
both packages load, the Adapter with template logits). Both entries then
evaluate it on ImageNet-A (both classes), ImageNet-Sketch (both classes)
and ImageNet-R cut to one class, which takes the row remap by wnid. Per
variant: top-1 equal, the other metrics within 1e-3 (percentage points),
the same class and image counts, and the same keys in ``ood_metrics.json``
and in each variant's metrics.json. A variant whose data is missing is
reported as an error in the summary and fails the entry, in both.
"""

import importlib
import json
import shutil
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
for path in (REPO, REPO / "scripts", REPO / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import clip_gp_tpu.data.datasets  # noqa: E402,F401
import clip_gp_tpu.methods  # noqa: E402,F401
from clip_gp_tpu.core.config import Config, save_config_to_file  # noqa: E402
from clip_gp_tpu.core.registry import build_trainer  # noqa: E402
from clip_gp_tpu.core.seeding import set_random_seed  # noqa: E402
from clip_gp_tpu.data.pipeline import build_data_manager  # noqa: E402
from clip_gp_tpu.models.clip_loader import init_clip_params, save_params_npz  # noqa: E402
from clip_gp_tpu.models.clip_model import ARCHITECTURES  # noqa: E402
from clip_gp_tpu_torch import ood_eval as port_ood  # noqa: E402
from test_dataset_catalogs import (  # noqa: E402
    build_imagenet,
    build_imagenet_a,
    build_imagenet_r,
    build_imagenet_sketch,
)

jax_ood = importlib.import_module("ood_eval")
VARIANTS = ("ImageNetA", "ImageNetR", "ImageNetSketch")
METRICS = ("top1_acc", "macro_f1", "ece", "aece")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("ood")
    weights = root / "test_vit.npz"
    arch = ARCHITECTURES["TEST-ViT"]
    save_params_npz(str(weights), arch, init_clip_params(jax.random.key(0), arch))
    build_imagenet(root)
    build_imagenet_a(root)
    build_imagenet_r(root)
    build_imagenet_sketch(root)
    # ImageNet-R keeps one of the two trained classes: the wnid remap
    shutil.rmtree(root / "imagenet-rendition" / "imagenet-r" / "n01443537")

    c = Config()
    c.trainer_name = "Adapter"
    c.dataset.name = "ImageNet"
    c.dataset.root = str(root)
    c.dataset.num_shots = 1
    c.model.backbone_name = "TEST-ViT"
    c.model.init_weights = str(weights)
    c.input.size = (32, 32)
    c.dataloader.batch_size_train = 4
    c.dataloader.batch_size_test = 4
    c.dataloader.num_workers = 0
    c.adapter.num_templates = 2
    c.adapter.clip_adapter_epochs = 2
    c.adapter.train_template_weights = True
    c.optim.max_epoch = 2
    c.train.print_freq = 100
    c.output_dir = str(root / "run")
    c.seed = 1
    set_random_seed(c.seed)
    trainer = build_trainer(c, build_data_manager(c))
    trainer.train()
    trainer.save_model(c.optim.max_epoch - 1, c.output_dir)
    save_config_to_file(c, str(Path(c.output_dir) / "config.json"))

    run = Path(c.output_dir)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
        for side, entry in (("jax", jax_ood.main), ("port", port_ood.main)):
            summary = run / f"ood_{side}.json"
            entry(["--model-dir", str(run), "--root", str(root),
                   "--variants", ",".join(VARIANTS), "--output", str(summary)])
            out[side] = {
                "summary": json.loads(summary.read_text()),
                "metrics": {v: json.loads((run / "ood" / v / "metrics.json").read_text())
                            for v in VARIANTS},
            }
    return {"root": root, "run": run, "out": out}


def test_summary_has_the_jax_keys(env):
    jax_s, port_s = env["out"]["jax"]["summary"], env["out"]["port"]["summary"]
    assert set(port_s) == set(jax_s)
    assert port_s["source_dataset"] == jax_s["source_dataset"] == "ImageNet"
    assert list(port_s["variants"]) == list(jax_s["variants"]) == list(VARIANTS)
    for v in VARIANTS:
        assert "error" not in port_s["variants"][v], port_s["variants"][v]
        assert set(port_s["variants"][v]) == set(jax_s["variants"][v])


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(env, variant):
    jax_row = env["out"]["jax"]["summary"]["variants"][variant]
    port_row = env["out"]["port"]["summary"]["variants"][variant]
    assert port_row["num_classes"] == jax_row["num_classes"] == (
        1 if variant == "ImageNetR" else 2)
    assert port_row["num_images"] == jax_row["num_images"]
    assert port_row["top1_acc"] == jax_row["top1_acc"]
    for key in METRICS:
        assert port_row[key] == pytest.approx(jax_row[key], abs=1e-3), key
    jax_m = env["out"]["jax"]["metrics"][variant]
    port_m = env["out"]["port"]["metrics"][variant]
    assert port_m["dataset"] == jax_m["dataset"] == variant
    assert set(port_m) == set(jax_m)
    assert set(port_m["metrics"]) == set(jax_m["metrics"])


def test_missing_variant_is_reported_as_in_jax(env, monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    for side, entry in (("jax", jax_ood.main), ("port", port_ood.main)):
        summary = env["run"] / f"ood_missing_{side}.json"
        with pytest.raises(SystemExit):
            entry(["--model-dir", str(env["run"]), "--root", str(env["root"]),
                   "--variants", "ImageNetV2", "--output", str(summary)])
        assert "error" in json.loads(summary.read_text())["variants"]["ImageNetV2"]
