"""The port's multi-device placement (``parallel/mesh.py``) and its use by
``BaseTrainer``, with two CPU slots standing in for two devices (the port's
answer to the JAX suite's virtual CPU devices):

- the sharded encode against one device's, on an odd batch;
- each case of ``extraction_shard_devices``'s gate, and no local devices
  on a host without a GPU or a CPU request;
- the trainer's encode plan, frozen until a weight reload, and its sharded
  extraction against the unsharded one;
- the ``dp2`` feature-cache key: the JAX package's key with
  ``shard_devices=2``, then the port's ``_torch-cpu``;
- ``sharded_train_step``'s summed gradients against one device's;
- the kernels' launch counter, exact under concurrent threads.
"""

import threading

import numpy as np
import pytest
import torch

from clip_gp_tpu_torch.core import device as device_mod
from clip_gp_tpu_torch.models.clip_loader import init_clip_params
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES
from clip_gp_tpu_torch.parallel import mesh

CPU2 = [torch.device("cpu"), torch.device("cpu")]


@pytest.fixture
def two_slots(monkeypatch):
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_FORCE_CPU", "1")
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION", raising=False)
    monkeypatch.setattr(device_mod, "local_devices", lambda: list(CPU2))
    return CPU2


def test_sharded_encode_matches_one_device_on_an_odd_batch(two_slots):
    arch = ARCHITECTURES["TEST-ViT"]
    model = init_clip_params(arch, seed=0, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, size=(7, 32, 32, 3),
                                               dtype=np.uint8)

    def encode(visual, u8):
        with torch.no_grad():
            return visual(u8.to(torch.float32) / 255.0).float()

    sharded = mesh.maybe_sharded_encode(encode, model.visual)
    assert sharded is not None and len(sharded.replicas) == 2
    # a replica on the module's own device is the module: one copy per device
    assert sharded.replicas[0] is model.visual
    got = sharded(images)
    want = model.encode_image(torch.from_numpy(images).float() / 255.0)
    assert got.shape == (7, arch.embed_dim)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)
    assert [hi - lo for lo, hi in mesh._chunk_bounds(7, 2)] == [4, 3]
    assert [len(c) for c in mesh.shard_batch(images, two_slots)] == [4, 3]


def test_extraction_gate(two_slots, monkeypatch):
    assert mesh.extraction_shard_devices() == two_slots
    with device_mod.pinned_device("cpu"):
        assert mesh.extraction_shard_devices() is None
        assert device_mod.resolve_device() == torch.device("cpu")
    assert mesh.extraction_shard_devices() == two_slots
    monkeypatch.setenv("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION", "0")
    assert mesh.extraction_shard_devices() is None
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    assert mesh.extraction_shard_devices() is None
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 1)
    assert mesh.extraction_shard_devices() == two_slots
    monkeypatch.setattr(device_mod, "local_devices", lambda: [torch.device("cpu")])
    assert mesh.extraction_shard_devices() is None
    assert mesh.maybe_sharded_encode(lambda m, x: x, torch.nn.Linear(2, 2)) is None


def test_no_local_devices_without_a_gpu_or_a_cpu_request(monkeypatch):
    """A caller that passes ``device="cpu"`` itself (no FORCE_CPU) on a host
    without a GPU: nothing to shard over, and the gate does not raise; a
    device left to ``resolve_device`` still does."""
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_FORCE_CPU", raising=False)
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_SHARD_EXTRACTION", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_mod.local_devices() == []
    assert mesh.extraction_shard_devices() is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()


def _argv(root, out, extra=()):
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "2",
        "--backbone", "TEST-ViT", "--seed", "1", "--output-dir", str(out),
        "--batch-size", "8", "--num-templates", "2",
        "INPUT.SIZE", "(32, 32)", "INPUT.TRANSFORMS", "['normalize']",
        "DATALOADER.NUM_WORKERS", "0", *extra,
    ]


def test_trainer_plan_is_frozen_until_reload_and_shards_extraction(
        two_slots, tmp_path, monkeypatch):
    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401
    from clip_gp_tpu_torch.core.config import parse_args_to_config
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager
    from clip_gp_tpu_torch.runtime import feature_cache

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.delenv("CLIP_GP_TPU_TORCH_FEATURE_CACHE", raising=False)
    config = parse_args_to_config(_argv(tmp_path / "data", tmp_path / "out"))
    set_random_seed(config.seed)
    trainer = build_trainer(config, build_data_manager(config))
    trainer.build_model()
    plan = trainer._encode_plan()
    assert plan["shard_devices"] == 2 and plan["shard_device_list"] == two_slots
    feature_cache.memo_clear()
    _, sharded = trainer.encode_images_batched(trainer.test_loader, cacheable=True)
    key = feature_cache.cache_key(config, trainer.test_loader.data_source,
                                  trainer.weights_tag, device_type="cpu",
                                  int8=False, shard_devices=2)
    assert key.endswith("_dp2_torch-cpu") and feature_cache.memo_get(key) is not None
    assert plan["sharded"] is not None
    # the gate flips; the plan does not until the weights are reloaded
    monkeypatch.setattr(device_mod, "local_devices", lambda: [torch.device("cpu")])
    assert trainer._encode_plan() is plan
    trainer.load_clip_model()
    assert trainer._encode_plan()["shard_devices"] == 0
    _, single = trainer.encode_images_batched(trainer.test_loader)
    np.testing.assert_allclose(sharded, single, atol=5e-5, rtol=5e-5)
    feature_cache.memo_clear()


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_dp2_key_is_the_jax_key_and_the_torch_tag(tmp_path, int8):
    from clip_gp_tpu.core.config import parse_args_to_config as jax_parse
    from clip_gp_tpu.data.datum import Datum as JaxDatum
    from clip_gp_tpu.runtime import feature_cache as jax_cache
    from clip_gp_tpu_torch.core.config import parse_args_to_config
    from clip_gp_tpu_torch.data.datum import Datum
    from clip_gp_tpu_torch.runtime import feature_cache

    argv = _argv(tmp_path, tmp_path / "out")
    if int8:
        argv += ["MODEL.INT8_INFERENCE", "True"]
    items = [(f"{tmp_path}/img_{i}.png", i % 3) for i in range(5)]
    want = jax_cache.cache_key(jax_parse(argv), [JaxDatum(p, y) for p, y in items],
                               "rand1", int8=int8, int8_fused=True, shard_devices=2)
    got = feature_cache.cache_key(parse_args_to_config(argv),
                                  [Datum(p, y) for p, y in items], "rand1",
                                  device_type="cpu", int8=int8, shard_devices=2)
    assert want.endswith("_dp2") and got == f"{want}_torch-cpu"


def test_sharded_train_step_gradients_match_one_device(two_slots):
    g = torch.Generator().manual_seed(0)
    d, k, n = 8, 4, 13
    params = {"w": torch.randn(d, k, generator=g), "b": torch.randn(k, generator=g)}
    feats = torch.randn(n, d, generator=g)
    labels = torch.arange(n) % k

    def loss_fn(p, f, y):
        return torch.nn.functional.cross_entropy(f @ p["w"] + p["b"], y)

    loss, grads = mesh.sharded_train_step(loss_fn, two_slots)(params, feats, labels)
    ref = {kk: v.clone().requires_grad_(True) for kk, v in params.items()}
    ref_loss = loss_fn(ref, feats, labels)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss.detach(), atol=1e-6, rtol=1e-6)
    for name in params:
        torch.testing.assert_close(grads[name], ref[name].grad, atol=1e-6, rtol=1e-6)


def test_launch_counter_is_exact_under_concurrent_threads():
    from clip_gp_tpu_torch.ops import _build

    counts = {"a": 0, "b": 0}
    n_threads, per_thread = 8, 5000
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait()
        for _ in range(per_thread):
            _build.count_launch(counts, "a" if i % 2 else "b")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert counts == {"a": n_threads // 2 * per_thread, "b": n_threads // 2 * per_thread}
    _build.reset_counts(counts)
    assert counts == {"a": 0, "b": 0}
