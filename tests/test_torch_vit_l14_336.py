"""CLIP ViT-L/14@336px in the port, on the CPU: its architecture entry and
benchmark configuration, its OpenAI state dict's shapes, a ViT tower past
256 tokens against the benchmark's plain float64 reference, the key-tiled
online softmax of K1's long-sequence attention core against the exact
softmax, the route by sequence length and its launch counter, and what the
wrappers refuse past 256 tokens. The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from clip_gp_tpu_torch.data.transforms import device_preprocess  # noqa: E402
from clip_gp_tpu_torch.models.clip_loader import (  # noqa: E402
    infer_arch_from_state_dict,
    init_clip_params,
)
from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES, ClipArchitecture  # noqa: E402
from clip_gp_tpu_torch.ops import flash_attention as fa  # noqa: E402
from clip_gp_tpu_torch.ops import int8_block as ib  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench.reference import clip as rclip  # noqa: E402

# a ViT past the strip kernel's 256 tokens at a size the CPU runs at once:
# (136 / 8)^2 + 1 = 290 tokens
LONG_VIT = ClipArchitecture("TEST-ViT-290", 32, 136, 2, 64, 8, transformer_width=64,
                            transformer_heads=1, transformer_layers=2)


def _cfg(arch):
    return {**dataclasses.asdict(arch), "backbone": arch.name}


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_the_entry_has_the_published_widths():
    """clip/clip.py's ``ViT-L/14@336px`` as clip/model.py ``build_model``
    reads it: embed 768, 336 px, 24 layers of width 1024 (16 heads of 64),
    patch 14; the text tower 12 layers of width 768, 12 heads, context 77,
    vocabulary 49,408."""
    arch = ARCHITECTURES["ViT-L/14@336px"]
    assert arch == ClipArchitecture("ViT-L/14@336px", 768, 336, 24, 1024, 14,
                                    context_length=77, vocab_size=49408,
                                    transformer_width=768, transformer_heads=12,
                                    transformer_layers=12)
    assert arch.vision_heads == 16
    assert (arch.image_resolution // arch.vision_patch_size) ** 2 + 1 == 577


def test_the_benchmark_configuration_is_the_entry():
    cfg = json.loads((ROOT / "port_bench/configs/vit_l14_336.json").read_text())
    assert cfg["backbone"] == "ViT-L/14@336px" and cfg["reduced"] == []
    harness.check_architecture(cfg)


def test_the_backbone_is_a_cli_choice():
    from clip_gp_tpu_torch.core.config import BACKBONE_CHOICES

    assert "ViT-L/14@336px" in BACKBONE_CHOICES


def _openai_vit_l14_336():
    """An OpenAI-layout state dict of ViT-L/14@336px's shapes, every tensor
    a zero-stride view of one float (no memory)."""
    zero = np.float32(0)

    def t(*shape):
        return np.broadcast_to(zero, shape)

    sd = {"visual.proj": t(1024, 768), "visual.conv1.weight": t(1024, 3, 14, 14),
          "visual.class_embedding": t(1024), "visual.positional_embedding": t(577, 1024),
          "text_projection": t(768, 768), "positional_embedding": t(77, 768),
          "token_embedding.weight": t(49408, 768), "ln_final.weight": t(768)}
    for i in range(24):
        sd[f"visual.transformer.resblocks.{i}.attn.in_proj_weight"] = t(3072, 1024)
    for i in range(12):
        sd[f"transformer.resblocks.{i}.attn.in_proj_weight"] = t(2304, 768)
    return sd


def test_an_openai_state_dict_maps_to_the_entry():
    arch = infer_arch_from_state_dict(_openai_vit_l14_336())
    assert dataclasses.replace(arch, name="ViT-L/14@336px") == ARCHITECTURES["ViT-L/14@336px"]


@pytest.mark.parametrize("name", ["ViT-L-14@336px.pt", "ViT-L-14-336px.pt"])
def test_the_loader_finds_either_file_name(tmp_path, monkeypatch, name):
    from clip_gp_tpu_torch.models import clip_loader

    monkeypatch.setenv("CLIP_GP_TPU_TORCH_WEIGHTS_DIR", str(tmp_path))
    (tmp_path / name).write_bytes(b"")
    found = [p for p in clip_loader._candidate_paths("ViT-L/14@336px") if p.exists()]
    assert found == [tmp_path / name]


# ---------------------------------------------------------------------------
# a tower past 256 tokens against the plain float64 reference
# ---------------------------------------------------------------------------

def test_a_long_sequence_vit_tower_matches_the_reference():
    """The port's ViT tower at 290 tokens (K1 and K2 take their plain
    versions on the CPU, past the strip kernel's limit) and its encode of
    uint8 images, against ``port_bench/reference/clip.py`` in float64 on the
    same seeded weights: within 1e-5 of each row's norm, as the benchmark's
    fp32 features are held (fp32 rounding over two layers reads 3e-7)."""
    seed = 3000000001
    images = np.random.default_rng(0).integers(0, 256, (3, 136, 136, 3), dtype=np.uint8)
    model = init_clip_params(LONG_VIT, seed, torch.device("cpu"))
    with torch.no_grad():
        got = model.encode_image(device_preprocess(torch.from_numpy(images)))
    w = rclip.to_device(rclip.random_weights(_cfg(LONG_VIT), seed), "cpu", torch.float64)
    ref = rclip.encode_images(w, _cfg(LONG_VIT), torch.from_numpy(images))
    assert got.shape == ref.shape == (3, 32)
    gap = ((got.double() - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    assert gap < 1e-5, gap


# ---------------------------------------------------------------------------
# the key-tiled core's arithmetic
# ---------------------------------------------------------------------------

def _heads(b, h, n, dh=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, dh, generator=g) for _ in range(3)]


def _round_tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b):
    """One TF32 pass: each operand rounded to 10 mantissa bits, the sums in
    fp32."""
    return _round_tf32(a.float()) @ _round_tf32(b.float())


# fp32 outputs of |o| <= ~3 summed over at most 577 keys in another order,
# the tile's exponentials carrying one more rounded factor: 2.3e-6 at most
# over the cases below, where one TF32 pass in the products errs by 2.5e-4
TILED_ATOL = 1e-5


@pytest.mark.parametrize("mask", ["none", "causal", "random"])
@pytest.mark.parametrize("n", [257, 577])
def test_the_key_tiled_online_softmax_matches_the_exact_softmax(n, mask):
    """``attention_key_tiled_plain``, the card's core in the order it reduces
    (tiles of 64 keys, a running max and sum, one division at the end),
    against the exact ``attention_plain`` in fp32 and in float64."""
    q, k, v = _heads(2, 3, n, seed=n)
    m = None
    if mask == "causal":
        m = torch.triu(torch.full((n, n), float("-inf")), 1)
    elif mask == "random":
        m = 2 * torch.randn(n, n, generator=torch.Generator().manual_seed(1))
    tiled = fa.attention_key_tiled_plain(q, k, v, m)
    exact = fa.attention_plain(q, k, v, m)
    exact64 = fa.attention_plain(q.double(), k.double(), v.double(),
                                 None if m is None else m.double(), mm=torch.matmul)
    assert tiled.dtype == torch.float32
    torch.testing.assert_close(tiled, exact, rtol=0, atol=TILED_ATOL)
    torch.testing.assert_close(tiled.double(), exact64, rtol=0, atol=TILED_ATOL)


def test_one_tf32_pass_misses_the_tolerance():
    """The tolerance tells 3xTF32 from one TF32 pass in the core's
    products."""
    q, k, v = _heads(2, 3, 577)
    gap = (fa.attention_key_tiled_plain(q, k, v, mm=_tf32_mm)
           - fa.attention_plain(q, k, v)).abs().max().item()
    assert gap > 10 * TILED_ATOL


def test_a_key_tile_of_every_key_is_the_exact_softmax_up_to_rounding():
    q, k, v = _heads(1, 2, 300)
    torch.testing.assert_close(fa.attention_key_tiled_plain(q, k, v, key_tile=300),
                               fa.attention_plain(q, k, v), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the route by N, its counter and the refusals
# ---------------------------------------------------------------------------

class _Library:
    """A stand-in for the kernel library: records which attention entry
    point ran."""

    def __init__(self):
        self.calls = []

    def cgt_attention(self, *args):
        self.calls.append("strip")
        return 0

    def cgt_attention_tiled(self, *args):
        self.calls.append("key_tiled")
        return 0


@pytest.mark.parametrize("n, route", [(1, "strip"), (197, "strip"), (256, "strip"),
                                      (257, "key_tiled"), (577, "key_tiled")])
def test_the_attention_core_routes_by_sequence_length(n, route):
    """Up to 256 tokens the strip kernel, uncounted; past them the key-tiled
    core, counted in ``LAUNCHES["key_tiled_attention"]``."""
    b, heads, d = 2, 2, 128
    lib = _Library()
    fa.reset_launch_counts()
    qkv = torch.zeros(b * n, 3 * d)
    attn = torch.zeros(b * n, d)
    fa._attention(lib, qkv, None, attn, b, n, heads, d, 0)
    assert lib.calls == [route]
    assert fa.LAUNCHES["key_tiled_attention"] == (route == "key_tiled")
    assert sum(fa.LAUNCHES.values()) == (route == "key_tiled")


def _k1(n, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(0)
    d = 128

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    x = rnd(1, n, d).requires_grad_(grad)
    return (x, torch.ones(d), torch.zeros(d), rnd(d, 3 * d, scale=d ** -0.5),
            torch.zeros(3 * d, dtype=dtype), rnd(d, d, scale=d ** -0.5),
            torch.zeros(d, dtype=dtype), 2)


def test_k1_and_k2_take_an_fp32_sequence_past_256_tokens():
    args = _k1(300)
    out = fa.fused_ln_attention_block(*args)
    torch.testing.assert_close(out, fa.ln_attention_block_plain(*args), rtol=0, atol=0)
    d = args[0].shape[-1]
    mlp = (out, torch.ones(d), torch.zeros(d), torch.zeros(d, 4 * d), torch.zeros(4 * d),
           torch.zeros(4 * d, d), torch.zeros(d))
    torch.testing.assert_close(fa.fused_ln_mlp(*mlp), out, rtol=0, atol=0)


@pytest.mark.parametrize("case, match", [
    ("bf16", "N <= 256 in torch.bfloat16"),
    ("gradient", "N <= 256 for a gradient"),
    ("k5", "no key-tiled form"),
], ids=["bf16", "gradient", "k5"])
def test_past_256_tokens_the_wrappers_refuse_what_the_core_does_not_take(case, match):
    """bf16 (its probabilities would round before they are normalised), a
    gradient (K3's attention backward holds every key) and the int8 core
    (K5) stop at 256 tokens, with a ValueError that says why."""
    n = 257
    with pytest.raises(ValueError, match=match):
        if case == "k5":
            d = 128
            ib.q8_ln_attention_block(
                torch.zeros(1, n, d), torch.ones(d), torch.zeros(d),
                torch.zeros(d, 3 * d, dtype=torch.int8), torch.ones(3 * d), torch.zeros(3 * d),
                torch.zeros(d, d, dtype=torch.int8), torch.ones(d), torch.zeros(d), 2)
        else:
            fa.fused_ln_attention_block(*_k1(n, torch.bfloat16 if case == "bf16" else
                                             torch.float32, grad=case == "gradient"))
