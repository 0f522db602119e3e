"""The port's native JPEG decode (``clip_gp_tpu_torch.native``) against the
JAX package's (``clip_gp_tpu.native``) on the same bytes, bit for bit, and
against the PIL path within ``tests/test_native_decode.py``'s bounds (mean
absolute difference under 4.0, under 6.0 on the DCT-scaled path). Both
libraries build from one C++ source with g++ and libjpeg; the file skips
where the port's cannot build."""

import io
import random

import numpy as np
import pytest
from PIL import Image

from clip_gp_tpu_torch.native import loader as port


@pytest.fixture(autouse=True)
def needs_native():
    # decided per test, not at import: the library builds at the first call
    if not port.native_available():
        pytest.skip(f"native decode unavailable: {port.unavailable_reason()}")


@pytest.fixture(scope="module")
def jax_native():
    from clip_gp_tpu.native import loader

    if not loader.native_available():
        pytest.skip("the JAX package's native decode did not build")
    return loader


def _jpeg_bytes(w, h, seed=0, quality=95):
    rng = np.random.default_rng(seed)
    # smooth image (noise compresses badly and amplifies codec differences)
    x = rng.normal(size=(h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(x, np.ones((8, 8, 1)))[:h, :w]
    img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _mean_abs(a, b):
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())


def _pil_center(jpeg, target):
    from clip_gp_tpu_torch.data.transforms import center_crop, resize_shortest

    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    img = resize_shortest(img, target, Image.BICUBIC)
    img = center_crop(img, (target, target))
    return np.asarray(img, dtype=np.uint8)


@pytest.mark.parametrize("w,h,bound", [(320, 240, 4.0), (240, 320, 4.0),
                                       (500, 375, 4.0), (224, 224, 4.0),
                                       (2000, 1500, 6.0)])
def test_decode_resize_crop_equals_jax_and_stays_near_pil(jax_native, w, h, bound):
    jpeg = _jpeg_bytes(w, h)
    ours = port.decode_resize_crop(jpeg, 224)
    assert ours is not None and ours.shape == (224, 224, 3)
    assert np.array_equal(ours, jax_native.decode_resize_crop(jpeg, 224))
    assert port.jpeg_dims(jpeg) == jax_native.jpeg_dims(jpeg) == (w, h)
    assert _mean_abs(ours, _pil_center(jpeg, 224)) < bound


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("w,h,box,bound", [
    (400, 300, (37, 22, 260, 211), 4.0),
    (2000, 1500, (100.0, 80.0, 1600.0, 1200.0), 6.0),  # DCT-scaled decode
])
def test_decode_rrc_equals_jax_and_stays_near_pil(jax_native, flip, w, h, box, bound):
    jpeg = _jpeg_bytes(w, h, seed=3)
    ours = port.decode_rrc(jpeg, box, 224, flip)
    assert ours is not None and ours.shape == (224, 224, 3)
    assert np.array_equal(ours, jax_native.decode_rrc(jpeg, box, 224, flip))
    x, y, bw, bh = box
    ref = Image.open(io.BytesIO(jpeg)).convert("RGB").crop(
        (int(x), int(y), int(x + bw), int(y + bh))).resize((224, 224), Image.BICUBIC)
    if flip:
        ref = ref.transpose(Image.FLIP_LEFT_RIGHT)
    assert _mean_abs(ours, np.asarray(ref, dtype=np.uint8)) < bound


def test_partial_decode_bit_identical_to_full():
    if not port.partial_decode_supported():
        pytest.skip("libjpeg-turbo's partial-decompression symbols are absent")
    w, h = 500, 375
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([((xx * xx + yy) % 256).astype(np.uint8),
                    (yy % 256).astype(np.uint8),
                    ((xx + yy) % 256).astype(np.uint8)], -1)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=85)
    jb = buf.getvalue()
    boxes = [(0.0, 0.0, float(w), float(h)), (0.0, 0.0, w * 0.4, h * 0.4),
             (w * 0.6, h * 0.6, w * 0.4, h * 0.4), (91.5, 40.25, 301.0, 233.0)]
    try:
        for flip in (False, True):
            for box in boxes:
                port.set_partial_decode(True)
                a = port.decode_rrc(jb, box, 224, flip)
                port.set_partial_decode(False)
                b = port.decode_rrc(jb, box, 224, flip)
                assert a is not None and np.array_equal(a, b), (box, flip)
    finally:
        port.set_partial_decode(True)


def test_invalid_bytes_and_degenerate_aspect_return_none():
    assert port.decode_resize_crop(b"not a jpeg", 224) is None
    assert port.decode_rrc(b"not a jpeg", (0, 0, 8, 8), 224, False) is None
    assert port.jpeg_dims(b"nope") is None
    # a 16000x2 JPEG would need a ~1.2 GB resize buffer: refused, PIL path
    buf = io.BytesIO()
    Image.fromarray(np.zeros((2, 16000, 3), np.uint8)).save(buf, format="JPEG",
                                                            quality=50)
    assert port.decode_resize_crop(buf.getvalue(), 224) is None


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_load_one_native_matches_jax_pipeline_and_keeps_the_rng_stream(
        jax_native, tmp_path, monkeypatch, is_train):
    """With the native path on, the port's ``_load_one`` returns the JAX
    pipeline's pixels bit for bit and leaves its rng where the JAX one does;
    on the train path the native and PIL branches consume the same draws."""
    import clip_gp_tpu.data.pipeline as jpipe
    import clip_gp_tpu_torch.data.pipeline as tpipe
    from clip_gp_tpu.core.config import Config as JConfig
    from clip_gp_tpu.data.datum import Datum as JDatum
    from clip_gp_tpu.data.transforms import build_transform as jbuild
    from clip_gp_tpu_torch.core.config import Config
    from clip_gp_tpu_torch.data.datum import Datum
    from clip_gp_tpu_torch.data.transforms import build_transform

    tree = tmp_path / "imgs"
    tree.mkdir()
    paths = []
    for i, (w, h) in enumerate([(400, 300), (300, 420), (640, 480)]):
        p = tree / f"img{i}.jpg"
        p.write_bytes(_jpeg_bytes(w, h, seed=7 + i))
        paths.append(str(p))

    def tfm(cfg_cls, build):
        c = cfg_cls()
        c.input.size = (224, 224)
        c.input.interpolation = "bicubic"
        c.input.transforms = ["random_resized_crop", "random_flip", "normalize"]
        return build(c, is_train=is_train)

    t_tfm, j_tfm = tfm(Config, build_transform), tfm(JConfig, jbuild)
    if is_train:
        assert t_tfm.native_rrc == j_tfm.native_rrc == {"target": 224, "flip": True}
    else:
        assert t_tfm.native_target == j_tfm.native_target == 224
    monkeypatch.setattr(tpipe, "_USE_NATIVE", True)
    monkeypatch.setattr(jpipe, "_USE_NATIVE", True)
    for path in paths:
        rng_t, rng_j = random.Random(123), random.Random(123)
        out_t = tpipe._load_one(Datum(impath=path, label=0, classname="x"), t_tfm,
                                rng_t if is_train else None)
        out_j = jpipe._load_one(JDatum(impath=path, label=0, classname="x"), j_tfm,
                                rng_j if is_train else None)
        assert np.array_equal(out_t, out_j)
        assert rng_t.random() == rng_j.random()
        if is_train:
            monkeypatch.setattr(tpipe, "_USE_NATIVE", False)
            rng_p = random.Random(123)
            out_p = tpipe._load_one(Datum(impath=path, label=0, classname="x"),
                                    t_tfm, rng_p)
            monkeypatch.setattr(tpipe, "_USE_NATIVE", True)
            rng_t2 = random.Random(123)
            tpipe._load_one(Datum(impath=path, label=0, classname="x"), t_tfm, rng_t2)
            assert rng_p.random() == rng_t2.random()
            assert _mean_abs(out_t, out_p) < 4.0
