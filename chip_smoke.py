#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clip_gp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc). Without a GPU, or without the package beside it, it
exits non-zero before printing any result. Phases, each raising on failure:

1. build: compiles the hand-written kernels (clip_gp_tpu_torch/csrc) and
   prints the build time, the card (``nvidia-smi`` name and power limit) and
   which optional host packages (PIL, yaml, regex) import;
2. kernels: K1 (fused LN-attention block) and K2 (fused LN-MLP block)
   against their plain PyTorch versions at the main path's shapes — ViT-B/16
   (B=32 and the training path's device batch B=512, N=197, D=768, H=12) and
   the text tower (B=256, N=77, D=512, H=8, causal) — in fp32 and bf16; K3
   and K4 (their backward kernels) at the prompt learners' shapes — the
   trimmed text tower (N=24, D=512, H=8, causal) at B=100 (a CoOp step on
   100 classes) and B=256 (a CoCoOp chunk at PROMPT_BUDGET), fp32, and B=256
   with a bf16 x — each asked for dx only (what the prompt learners launch)
   and for all seven gradients, at B=400 (a trial-batched CoOp step
   of phase 11: 4 trials x 100 classes) and at B=800 (one image chunk of
   a trial-batched CoCoOp step: 4 trials x 2 images x 100 classes), with K1
   and K2 at the same two batches (N=24, fp32, causal); K3 also at B=100 on
   the untrimmed text tower (N=77, fp32); K5 and K6 (the int8 blocks of the serving
   tower) at ViT-B/16 B=32 and B=512 in bf16 (the serving dtype) and B=32
   in fp32; K7 (standalone attention on [B, H, N, Dh]) at ViT-B/16's heads
   (B=32 and B=512, H=12, N=197, Dh=64) and the text tower's (B=256, H=8,
   N=77, causal) in fp32 and bf16, and at B=32 with 24 heads of 32 in bf16;
   K8 (the qkv-attention-out block without LN or residual) at ViT-B/16
   B=32 and B=512 in fp32 and bf16. Each cell reports the error against the
   stated tolerance and CUDA-event times (median of 20 after warm-up) of the
   kernel (``kernel_ms``; ``ms`` in the JSON line carries the same number),
   the plain version and a library yardstick, beside the least time the
   card could take (``bound_ms``; fp32 operations at the faster of the
   CUDA cores and 3xTF32 on the tensor cores). Then, untimed, a sweep of the
   attention core that K1, K5, K7 and K8 share (K7 at N 1 to 256 across its
   strip and chunk edges, Dh 32 and 64, both dtypes, no mask, causal and a
   random finite mask; K1, K5 and K8 at N=17 and 256), printing the largest
   error per group; a sweep of K3's attention-core backward
   (attention_bwd.cu, called directly at N 1 to 256 across its key-tile
   buckets and 16-row strips, no mask, causal and a random finite mask, with
   and without the head outputs), printing the largest error over its limit
   per mask; a sweep of the GEMM that K1, K2 and K8 share, in bf16
   (its own kernel) and fp32 (the 3xTF32 core of gemm_tf32.cuh, with each
   of its three tile shapes), each of its five epilogues called directly and
   the three blocks, at the edges of its output and k tiles (GEMM_SWEEP_*),
   printing the largest error per dtype, epilogue and block, then each fp32
   forward product timed with each tile shape (GEMM_TILE_CELLS); a sweep of
   the same core as K3 and K4 launch it, each of their six products called
   directly with each tile shape and both io dtypes at the edges of its
   tiles (GEMM_BWD_SWEEP_*), printing the largest error per product and
   dtype, then the dx products timed with each tile shape
   (GEMM_BWD_TILE_CELLS); the ``[int8 gemm]`` cells: each int8 product of
   K5 and K6 (Q8_GEMM_PRODUCTS) called directly at ViT-B/16 B=32 and
   B=512 in bf16, held bit for bit to its plain version at B=32 and timed
   per call and back to back beside its own bound and ``torch._int_mm``;
   and a ``torch.profiler``
   trace of three calls each of K1, K2 and K8 at ViT-B/16 B=512 in bf16
   and fp32, of K5 and K6 in bf16 and of K3 and K4 in fp32 (dx only and all gradients, text B=256 N=24),
   printing the device time per call of each CUDA kernel by name, and for
   K3 its attention backward's time beside that part's own bound;
3. towers: a ViT-B/16 ``encode_image`` (fp32, 32 images at 224), its int8
   ``encode_image_q8`` (bf16, the same images) and an ``encode_text`` (256
   prompts) with random weights, and the gradient of a CoOp-shaped loss
   with respect to 100 prompts' embeddings (N=24) through the text tower,
   each through the kernels and through the plain versions, compared;
4. trainer: the Adapter + GP flow of ``train.py --use-gp`` on ViT-B/16
   (``build_trainer(config, dm)`` → ``trainer.train()``) over an in-memory
   synthetic dataset, checking metrics.json and that every frozen encode
   launched K1 and K2;
5. CoOp: ``Adapter-CoOp`` on ViT-B/16 over 100 synthetic classes (4 shots,
   n_ctx 16, batch 32, 2 epochs), checking metrics.json, that the context
   moved, and that every step launched K1-K4 in each of the 12 blocks;
6. CoCoOp: ``Adapter-CoCoOp`` on the same 100 classes (1 shot, 1 epoch),
   the same checks, K1/K2 counted twice per block and chunk (the forward
   and its recompute under ``torch.utils.checkpoint``);
7. serving: the CLI (``clip_gp_tpu_torch.train``) trains the Adapter on
   ViT-B/16 for one epoch over the Synthetic dataset with checkpoints on
   (Pillow decode), then serves the run: ``--eval-only`` with
   ``MODEL.INT8_INFERENCE True`` and the predict entry
   (``clip_gp_tpu_torch.predict --int8``) over 64 PNGs at 224x224, checking
   metrics.json, predictions.json, that every ViT block of every int8 image
   encode launched K5 and K6 and that no image encode launched K1/K2; it
   prints the int8 and fp32 encode rates on one batch and how often their
   top-1 agree;
8. building blocks: the public API of K7 and K8 at ViT-B/16 width: a loss
   through ``fused_attention_block`` (B=32, fp32) forward (K8) and backward
   (the eager math's VJP) against autograd of its plain version, then the
   lineage comparison of the JAX package at B=512 in bf16 and fp32: the
   attention sub-block ``x + MHA(LN(x))`` as (a) K1, (b) LN rounded to the
   working type, K8, ``+ x``, and (c) LN, ``F.linear`` qkv, K7,
   ``F.linear`` out-projection, ``+ x``; (b) and (c) each held against the
   same composition of plain versions, and all three timed;
9. RN50, the paper's backbone (BASELINE configs #1-#3): a random RN50
   state dict in the OpenAI layout (vision width 64, layers (3, 4, 6, 3),
   224 px, embed 1024, text 512/8/12; random BatchNorm statistics) is saved
   to a temporary ``.pt`` and loaded through ``load_clip_resolved`` with
   ``MODEL.INIT_WEIGHTS``; its ``encode_image`` (fp32, 8 images) on the card
   against the same model on the CPU (``TOWER_TOL`` of the largest feature)
   with no kernel launched (path ``rn50_encode``: the ResNet tower is
   cuDNN convolutions and a plain attention pool), then its fp32 encode
   rate at B=32 and B=512 beside the card's name and power limit; then,
   each loaded from that ``.pt``, the Adapter with the GP (``--use-gp``,
   BASELINE #1/#2) and the three feature-cached heads of #3 — CLIP-Adapter
   with the GP pre-stage, TaskRes and Tip-Adapter-F — for 3 epochs each
   (paths ``rn50_adapter_gp``, ``rn50_clip_adapter_gp``, ``rn50_taskres``,
   ``rn50_tip_adapter_f``), checking metrics.json and that K1 and K2
   launched exactly once in each of the text tower's 12 blocks per template
   encode and never from an RN image encode; and one CLIP-Adapter epoch on
   ViT-B/16 (path ``vit_clip_adapter``), whose every step re-encodes its
   images through K1/K2 in all 12 blocks;
10. single-trial surfaces, on ViT-B/16 through the CLI over the Synthetic
   dataset (4 classes, 4 shots, 16 templates, 3 epochs): (a) the Adapter +
   GP with ``--optimizer muon``, ``TRAIN.ENABLE_TENSORBOARD``, the feature
   cache (``CLIP_GP_TPU_TORCH_FEATURE_CACHE``) and a ``torch.profiler``
   trace (``CLIP_GP_TPU_TORCH_PROFILE_DIR``), printing ``[single-trial]``
   lines with the phase report (``feature_extraction``, ``train_epochs``),
   the cache file, the TensorBoard outcome, the trace and the K1/K2
   launches (exactly the text, train and test encodes); (b) one Muon step
   from the trained parameters and their gradient on the card, with
   cuBLAS's reduced-precision bf16 reductions on and off, against the CPU
   (MUON_TOL); (c) the same run again from an empty memo: the test split
   loads from the disk cache bit for bit, and K1/K2 launch only for the
   text and train encodes; (d) ``FINETUNE_ON_TEST``: 100 ``[SANITY]``
   epochs; (e) the state of (a) written as a reference-format
   ``model.pth.tar-3`` and served by ``--eval-only`` against its npz: top-1
   equal, metrics within 1e-3; (f) an ImageNet-layout tree of
   OOD_CLASSES classes at 224 px, the Adapter trained on it for 1 epoch,
   then ``clip_gp_tpu_torch.ood_eval`` on ImageNet-V2 (every class) and
   ImageNet-A (OOD_SUBSET classes, remapped by wnid) (paths
   ``single_trial``, ``cached``, ``finetune_on_test``, ``eval_npz``,
   ``ref_ckpt``, ``ood_train``, ``ood``);
11. sweep: the sweep runner (``clip_gp_tpu_torch.parallel.sweep.main``,
   ``--backend vmap --strict-vmap``) on ViT-B/16 over Synthetic PNG trees
   from experiment YAMLs built on the repo's ``configs/trainers``: the GP
   trainer's config over seeds 1-4 x a two-value ``OPTIM.LR`` grid (one
   group, T=8; K1/K2 exactly once per group for the text, union and test
   encodes), ``Adapter-CoOp`` on 100 classes, 1 shot (T=4, 2 epochs; K1-K4
   exactly once per block per step at T x K prompts, every trial's context
   moved), ``Adapter-CoCoOp`` on the same 100 classes (T=4, one step of
   all 100 images: 50 checkpointed chunks of T x 2 images x 100 prompts,
   K1/K2 twice and K3/K4 once per block per chunk, once per block per eval
   chunk, every trial's ctx and meta-net moved; its seed-1 trial in-process
   with top-1 and macro-F1 equal) and Tip-Adapter-F (T=4; the val split and
   each trial's (beta, alpha) on the grid), each beside its first trial run
   in-process; the Adapter without the GP (T=8) against its trial (seed 1,
   the first lr) run by ``--backend inprocess`` and by ``--backend
   subprocess --devices 0`` (top-1 equal, metrics within
   SWEEP_METRIC_TOL); the decode-ahead pair: the GP trainer's config at 1
   and 2 shots on the 100-class tree (two feature-cached groups of T=4) with
   ``CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH=1`` and then with
   decode-ahead, which must announce ``prefetching group 2/2`` and write
   every metrics.json equal but for its wall-clock fields, both wall times
   printed; then the aggregator over the output tree (``--no-plots``
   without matplotlib). ``[sweep]`` lines give each group's seconds,
   seconds per trial beside the in-process trial's, the ``vmap.*`` phase
   report and the card (paths ``sweep_adapter_gp``, ``sweep_coop``,
   ``sweep_cocoop``, ``sweep_tip_f``, ``sweep_adapter``,
   ``sweep_inprocess``, ``sweep_prefetch_sequential``,
   ``sweep_prefetch_decode_ahead`` and the ``*_trial`` runs; the child
   process's launches are counted in the child);
12. native decode and multi-device placement: ``[native]``: whether the
   port's C++ JPEG decode (``clip_gp_tpu_torch/native``) built, and why
   not; where it did, 16 generated JPEGs decoded natively and through PIL
   (mean absolute difference under 4.0) and a short CLI run over a
   Synthetic JPEG tree with ``CLIP_GP_TPU_TORCH_NATIVE_DECODE=1``.
   ``[multi-gpu]``: the device count, then two GP groups (the GP trainer's
   config at 1 and 2 shots on the 4-class tree, T=4) through
   ``sweep.main --backend vmap`` one after another, with
   ``--group-parallel 2`` and with ``--trial-mesh auto``: every
   metrics.json field but the wall clock equal to the sequential run's, and
   the K1/K2 launches too (paths ``multi_sequential``,
   ``multi_group_parallel``, ``multi_trial_mesh_auto``); with two or more
   devices also the sharded extraction against one device's
   (MESH_ENCODE_TOL), ``--trial-mesh 2`` against the sequential run (top-1
   equal, SWEEP_METRIC_TOL; path ``multi_trial_mesh_2``) and K1 launched
   from a thread whose current device is another; with one device the
   line says which of these did not run and why;
13. scripts: every module of ``clip_gp_tpu_torch.scripts`` through its
   ``run(...)`` at full width (ViT-B/16 and RN50 towers) with classes,
   images, epochs and steps cut, each report printed as a ``[scripts]``
   line with the phase's seconds: ``quick_check`` (eight OK),
   ``parity_check`` (``--convert`` of phase 9's ``rn50_state_dict()``
   ``.pt``, then config 1 on a Caltech101-layout tree, NO-REF, then OK
   against a fabricated reference), ``bench_backbones`` (ViT-B/16 and
   RN50 at B=128), ``bench_int8_encode`` (int8 against bf16 features at
   cosine SCRIPTS_INT8_COS), ``bench_gp``, ``bench_trial``,
   ``profile_vmap_group``, ``bench_sweep``, ``bench_coop_vmap``,
   ``bench_cocoop_vmap``, ``bench_cocoop``, ``bench_cocoop_profile``,
   ``bench_fused_vjp`` (kernels against library gradients within
   SCRIPTS_GRAD_TOL of the largest), ``bench_sweep_methods`` (one dataset
   per family), ``bench_cocoop_imagenet_scale`` (K=100, T=2) and
   ``bench_sweep_projection`` (one dataset at two shot counts); one path,
   ``scripts``, which must launch K1-K6;
14. output: one ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Each of phases 4-13 sets the launch counts to 0 just before each run it
drives and reads them just after; a kernel's ``launches`` in the JSON line is
the sum over those runs, and ``launches_by_path`` gives each.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

# Published dense peaks (NVIDIA data sheet, H100 SXM at 700 W): FLOP/s for
# fp32 on the CUDA cores, TF32 and bf16 on the tensor cores, int8
# tensor-core operations/s, and memory bytes/s.
PEAKS = {
    "H100": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12,
             "bytes": 3.35e12},
}

# kernel → (source, TPU kernel replaced)
CSRC = "clip_gp_tpu_torch/csrc/"
KERNELS = {
    "fused_ln_attention_block": (
        f"{CSRC}ln_gemm.cu + {CSRC}gemm_tf32.cuh + {CSRC}gemm_bwd.cu (LN pass) "
        f"+ {CSRC}attention.cu",
        "clip_gp_tpu/ops/flash_attention.py:845",
    ),
    "fused_ln_mlp": (
        f"{CSRC}ln_gemm.cu + {CSRC}gemm_tf32.cuh + {CSRC}gemm_bwd.cu (LN pass)",
        "clip_gp_tpu/ops/flash_attention.py:329",
    ),
    "ln_attn_bwd": (
        f"{CSRC}gemm_bwd.cu + {CSRC}gemm_tf32.cuh + {CSRC}attention_bwd.cu "
        f"+ {CSRC}ln_bwd.cu",
        "clip_gp_tpu/ops/flash_attention.py:668",
    ),
    "ln_mlp_bwd": (
        f"{CSRC}gemm_bwd.cu + {CSRC}gemm_tf32.cuh + {CSRC}ln_bwd.cu",
        "clip_gp_tpu/ops/flash_attention.py:476",
    ),
    "q8_ln_attention_block": (
        f"{CSRC}int8_block.cu + {CSRC}attention.cu",
        "clip_gp_tpu/ops/int8_block.py:66",
    ),
    "q8_ln_mlp": (
        f"{CSRC}int8_block.cu",
        "clip_gp_tpu/ops/int8_block.py:194",
    ),
    "flash_attention": (
        f"{CSRC}attention.cu",
        "clip_gp_tpu/ops/flash_attention.py:34",
    ),
    "fused_attention_block": (
        f"{CSRC}ln_gemm.cu + {CSRC}gemm_tf32.cuh + {CSRC}attention.cu",
        "clip_gp_tpu/ops/flash_attention.py:174",
    ),
}

# (name, batch, tokens, width, heads, causal, dtypes): the main path's two
# towers — ViT-B/16 at 32 images and at the image-encode device batch of the
# training path (methods/common.py extract_device_batch()), the text tower at
# the template-encode batch (encode_templates' batch_size), and the trimmed
# text tower's forward in a trial-batched CoOp step of phase 11 (T x K =
# 4 x 100 prompts of 24 tokens, in the prompt tower's fp32) and in one
# image chunk of a trial-batched CoCoOp step (T x C x K = 4 x 2 x 100)
SHAPES = [
    ("vit-b16", 32, 197, 768, 12, False, ("fp32", "bf16")),
    ("vit-b16", 512, 197, 768, 12, False, ("fp32", "bf16")),
    ("text", 256, 77, 512, 8, True, ("fp32", "bf16")),
    ("text-coop-sweep", 400, 24, 512, 8, True, ("fp32",)),
    ("text-cocoop-sweep", 800, 24, 512, 8, True, ("fp32",)),
]

# Kernel vs plain tolerances, elementwise |kernel - plain| <= atol + rtol*|plain|.
# fp32: both sum the same fp32 products in different orders; a K-term fp32
# dot (K up to 3072) drifts by ~sqrt(K)*2^-24 of its magnitude, ~1e-5 here.
# bf16: values are rounded to bf16 (8 significant bits) at the same points on
# both sides, so a different summation order can flip one rounding: one bf16
# ulp, at most 2^-7 of the value, plus 2^-6 absolute for values near zero.
TOLERANCES = {"fp32": (1e-4, 1e-4), "bf16": (2.0**-6, 2.0**-7)}
# (name, batch, tokens, width, heads, x dtype, kernels) of the backward
# cells: the trimmed text tower of the prompt learners (n_ctx 16 + a class
# name covers 24 positions), a CoOp step on 100 classes and a CoCoOp chunk
# of 256 prompts; K3 at a CoOp step on the untrimmed tower
# (CLIP_GP_TPU_TORCH_TRIM_PROMPTS=0: 77 tokens); a trial-batched CoOp
# step of phase 11 (T x K = 4 x 100 prompts) and one image chunk of a
# trial-batched CoCoOp step (T x C x K = 4 x 2 x 100 prompts)
BWD_SHAPES = [
    ("coop", 100, 24, 512, 8, "fp32", ("ln_attn_bwd", "ln_mlp_bwd")),
    ("cocoop", 256, 24, 512, 8, "fp32", ("ln_attn_bwd", "ln_mlp_bwd")),
    ("cocoop", 256, 24, 512, 8, "bf16", ("ln_attn_bwd", "ln_mlp_bwd")),
    ("coop-untrimmed", 100, 77, 512, 8, "fp32", ("ln_attn_bwd",)),
    ("coop-sweep", 400, 24, 512, 8, "fp32", ("ln_attn_bwd", "ln_mlp_bwd")),
    ("cocoop-sweep", 800, 24, 512, 8, "fp32", ("ln_attn_bwd", "ln_mlp_bwd")),
]
# K3/K4 kernel vs plain: both recompute the block in fp32 and sum up to
# T = B·N rows of fp32 products into each weight gradient, in other orders;
# the error scales with the gradient's largest value. Allowed, elementwise:
# 1e-4 x (max |plain| + |plain|), or one bf16 ulp of that for a gradient
# that comes out in bf16 (dx of a bf16 x).
BWD_RTOL = {"fp32": 1e-4, "bf16": 2.0**-7}
# encoded features after 12 (or 12 text) layers, kernels vs plain, fp32:
# the fp32 per-block drift above (~1e-5 of the values) compounds over 12
# blocks; allowed: 1e-4 of the largest feature
TOWER_TOL = 1e-4
# (name, batch, tokens, width, heads, x dtype) of the K5/K6 cells: ViT-B/16
# at 32 images and at the image-encode device batch, in the serving dtype
# (bf16), and at 32 images in fp32
Q8_SHAPES = [
    ("vit-b16", 32, 197, 768, 12, "bf16"),
    ("vit-b16", 512, 197, 768, 12, "bf16"),
    ("vit-b16", 32, 197, 768, 12, "fp32"),
]
# the four int8 products of K5 and K6 at ViT-B/16's width (D = 768) for the
# [int8 gemm] cells: (name, N, K, epilogue, group_k), group_k None for one
# group over all of K, 64 (a head) for the out-projection
Q8_GEMM_PRODUCTS = [("qkv", 2304, 768, "qkv", None),
                    ("out-proj", 768, 768, "resid_attn", 64),
                    ("c_fc", 3072, 768, "gelu", None),
                    ("c_proj", 768, 3072, "resid_mlp", None)]


# K5/K6 kernel vs plain: the int8 products are exact on both sides; an fp32
# sum taken in another order (LN statistics, softmax, p·v) can move one
# activation across a quantization boundary, which moves the outputs it
# feeds by one quantization step times the weights (up to ~1e-2 here) and,
# in fp32, every query of that image. Both working types are held to one
# bf16 ulp (2^-6 + 2^-7·|plain|) for at least 99.9% of the elements, and a
# mean |Δ| of at most 1e-3 of the mean |plain|.
Q8_TOL = {"atol": 2.0**-6, "rtol": 2.0**-7, "share": 0.999, "mean": 1e-3}
# int8 towers after 12 layers, kernels vs plain: cosine per image
Q8_TOWER_COS = 0.9999
# (name, batch, heads, tokens, head width, causal, dtypes) of the K7 cells:
# the attention cores of ViT-B/16 and the text tower at phase 2's batches,
# and ViT-B/16's width in heads of 32 (the other head width K7 takes)
K7_SHAPES = [
    ("vit-b16", 32, 12, 197, 64, False, ("fp32", "bf16")),
    ("vit-b16", 512, 12, 197, 64, False, ("fp32", "bf16")),
    ("text", 256, 8, 77, 64, True, ("fp32", "bf16")),
    ("vit-b16-dh32", 32, 24, 197, 32, False, ("bf16",)),
]
# the attention core's sweep (phase 2, untimed): K7 at the edges of the
# core's 16-row query strips and 16-key (bf16) or 8-key (fp32) chunks, at
# the two towers' sequences and at the 256-token limit, under each mask of
# _sweep_mask; K1, K5 and K8 at one strip plus a row and at the limit
CORE_SWEEP_N = (1, 15, 16, 17, 50, 77, 197, 255, 256)
CORE_SWEEP_MASKS = ("none", "causal", "random")
CORE_BLOCK_N = (17, 256)
# the attention backward's sweep (phase 2, untimed): the core of K3
# (attention_bwd.cu) called directly on random fp32 qkv and d_attn at the
# edges of its buckets of 8-key tiles (3, 4 and 10 in one launch; 32 split
# past 80 tokens) and of its 16-row strips, under each mask of
# _sweep_mask, with and without the head outputs; held to BWD_RTOL of
# attention_bwd_plain
ATTN_BWD_SWEEP_N = (1, 15, 16, 17, 24, 33, 77, 80, 81, 128, 129, 256)
# the GEMM's sweep (phase 2, untimed): the product of ln_gemm.cu in bf16 (its
# own kernel: 128x128 output tiles, 64-deep k-tiles) and fp32 (the 3xTF32
# core with each tile shape: 128x128, 128x64, 64x64; 16-deep k-tiles) at the
# edges of its tiles. Each epilogue called directly over GEMM_SWEEP_ROWS rows
# (one, a row short of and past a tile, ViT-B/16 at 32 images) and
# GEMM_SWEEP_KN ((K, N): c_fc and c_proj at D = 200, so N = 800 and 200 are
# not multiples of 128 or 64 and K = 200 not of 64 or 16); then K1 and K8 at
# D = 192 (3 heads: N = 576 and 192) and K2 at D = 200 over the same row
# counts as (batch, tokens). Then each fp32 forward product (GEMM_TILE_CELLS:
# shape, M = B·N, product, N, K, epilogue) at ViT-B/16 B=32 and B=512 and
# the text tower's template encode B=256 is timed with each tile shape,
# beside the one _tile_plan picks.
GEMM_SWEEP_ROWS = (1, 127, 129, 6304)
GEMM_SWEEP_KN = ((200, 800), (800, 200))
GEMM_SWEEP_BLOCKS = ((1, 1), (1, 127), (1, 129), (32, 197))
GEMM_TILE_CELLS = [
    (f"{tower} B={b}", b * n, product, width, k, epilogue)
    for tower, b, n, d in (("ViT-B/16", 32, 197, 768), ("ViT-B/16", 512, 197, 768),
                           ("text", 256, 77, 512))
    for product, width, k, epilogue in (("qkv", 3 * d, d, "qkv"),
                                        ("out-proj", d, d, "resid_attn"),
                                        ("c_fc", 4 * d, d, "gelu"),
                                        ("c_proj", d, 4 * d, "resid_mlp"))
]
# the backward GEMM's sweep (phase 2, untimed): each of the six products of
# K3 and K4 (GEMM_BWD_OPS, the 3xTF32 core of gemm_bwd.cu) called directly
# after the pass that writes its A, with each tile shape and x / dout in
# fp32 and bf16, at the edges of its 128x128, 128x64 and 64x64 output tiles
# and 16-deep k-tiles: M over GEMM_BWD_SWEEP_ROWS (one row, a row short of and
# past a tile, the text tower at 100 prompts; for a "tn" product M is the
# contiguous dimension of A [K, M], so 1, 127 and 129 take its 4-byte
# copies), N over GEMM_BWD_SWEEP_N (200 and 808 are not multiples of 64) and
# K over GEMM_BWD_SWEEP_K (24 and 520 are not multiples of 16; 6,144 rows
# make a weight gradient split K); held to BWD_RTOL. Then each dx product of
# K3 and K4 at text B=100 and 256 (GEMM_BWD_TILE_CELLS: M = T, N, K) is
# timed with each tile shape, beside the one _gemm_bwd_plan picks.
GEMM_BWD_SWEEP_ROWS = (1, 127, 129, 2400)
GEMM_BWD_SWEEP_N = (200, 808, 1536)
GEMM_BWD_SWEEP_K = (24, 520, 6144)
GEMM_BWD_TILE_CELLS = [
    (op, t, n, k)
    for t in (2400, 6144)
    for op, n, k in (("ln_nn_bias", 1536, 512), ("nt", 512, 512),
                     ("nt", 512, 1536), ("ln_nn_bias", 2048, 512),
                     ("nt_gelu_bwd", 2048, 512), ("nt", 512, 2048))
]
# (name, batch, tokens, width, heads) of the K8 cells, fp32 and bf16
K8_SHAPES = [
    ("vit-b16", 32, 197, 768, 12),
    ("vit-b16", 512, 197, 768, 12),
]
# building-block compositions (b) and (c) of phase 8 against the same
# compositions of plain versions: fp32 as TOLERANCES; bf16 two ulps, since
# each composition rounds twice after the kernel (the block's output, then
# the residual add), and each rounding can flip once
LINEAGE_TOL = {"fp32": (1e-4, 1e-4), "bf16": (2.0**-5, 2.0**-6)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}: add them to PEAKS")


def op_rate(peaks: dict, dtype_name: str) -> float:
    """Operations/s of the operations bound. fp32: the faster of the CUDA
    cores and the tensor cores at 3xTF32 (three TF32 products per fp32
    product), the least time at fp32 accuracy on the card, whatever kernel
    implements the cell."""
    if dtype_name == "fp32":
        return max(peaks["fp32"], peaks["tf32"] / 3)
    return peaks[dtype_name]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_back_to_back(fn, launches: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of ``launches`` calls made back to back, over their
    count, in ms: the host's time to make a call overlaps the card's work on
    the one before, where ``time_ms`` adds it to each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def compare(out, ref, atol: float, rtol: float):
    """(max abs error, max error relative to atol + |ref|, within tolerance)."""
    max_abs, max_rel, _, ok = compare_margin(out, ref, atol, rtol)
    return max_abs, max_rel, ok


def compare_margin(out, ref, atol: float, rtol: float):
    """``compare``'s (max abs error, max error relative to atol + |ref|) and
    the largest error over its limit atol + rtol·|ref| (the margin), then
    whether every error is within its limit."""
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    max_rel = (diff / (atol + ref.float().abs())).max().item()
    return (diff.max().item(), max_rel, (diff / limit).max().item(),
            bool((diff <= limit).all().item()))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def _log_instantiations(source, ptxas):
    """One line per kernel of a ptxas -v log: its template arguments,
    registers and spill stores and loads."""
    for entry in ptxas.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        args = ", ".join(a.replace("n", "-") for a in re.findall(r"Li(n?\d+)E", name))
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.findall(r"(\d+) bytes spill (stores|loads)", entry)
        spill = ", ".join(f"{n} bytes spill {kind}" for n, kind in spills)
        log(f"[build] ptxas {source} <{args}>: "
            f"{regs.group(1) if regs else '?'} registers, {spill}")


def phase_build():
    import torch

    from clip_gp_tpu_torch.core.device import resolve_device
    from clip_gp_tpu_torch.ops import _build

    device = resolve_device("cuda")
    start = time.perf_counter()
    _build.library()
    log(f"[build] kernels built in {time.perf_counter() - start:.2f} s "
        f"({_build.BUILD_DIR})")
    if not _build.last_build["cached"]:
        # nvcc's -Xptxas -v output, one "== <source>" section per file
        for section in _build.last_build["ptxas"].split("== ")[1:]:
            source, _, ptxas = section.partition("\n")
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
            spills = [int(s) for s in re.findall(r"(\d+) bytes spill", ptxas)]
            log(f"[build] ptxas {source}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers a thread, {sum(spills)} bytes of spills")
            if source.startswith(("attention_bwd", "int8_block")):
                _log_instantiations(source, ptxas)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    for mod in ("PIL", "yaml", "regex"):
        try:
            __import__(mod)
            log(f"[build] import {mod}: ok")
        except ImportError:
            log(f"[build] import {mod}: missing")
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return device, smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _block_inputs(b, n, d, causal, dtype, device, seed):
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    p = {
        "x": rnd(b, n, d).to(dtype),
        "ln_scale": 1 + 0.1 * rnd(d), "ln_bias": 0.1 * rnd(d),
        "w_qkv": rnd(d, 3 * d, scale=d**-0.5).to(dtype),
        "b_qkv": (0.1 * rnd(3 * d)).to(dtype),
        "w_out": rnd(d, d, scale=d**-0.5).to(dtype),
        "b_out": (0.1 * rnd(d)).to(dtype),
        "w_fc": rnd(d, 4 * d, scale=d**-0.5).to(dtype), "b_fc": 0.1 * rnd(4 * d),
        "w_proj": rnd(4 * d, d, scale=(4 * d) ** -0.5).to(dtype),
        "b_proj": 0.1 * rnd(d),
    }
    p["mask"] = (
        torch.triu(torch.full((n, n), float("-inf"), device=device), 1)
        if causal else None
    )
    return p


def _block_args(kernel, p, heads):
    """The positional arguments of a block kernel's wrapper, which its plain
    version takes too, from ``_block_inputs`` (``_q8_block_inputs`` for K5
    and K6)."""
    if kernel == "fused_ln_attention_block":
        return (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"],
                p["w_out"], p["b_out"], heads, p["mask"])
    if kernel == "fused_ln_mlp":
        return (p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"],
                p["w_proj"], p["b_proj"])
    if kernel == "fused_attention_block":
        return (p["x"], p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], heads,
                p["mask"])
    # K5/K6 with the weights' K-major copies, as the int8 tower passes them
    if kernel == "q8_ln_attention_block":
        wq, wo = p["w_qkv"], p["w_out"]
        return (p["x"], p["ln_scale"], p["ln_bias"], wq["q"], wq["scale"],
                p["b_qkv"], wo["q"], wo["scale"], p["b_out"], heads, p["mask"],
                wq["qt"], wo["qt"])
    wf, wp = p["w_fc"], p["w_proj"]  # q8_ln_mlp
    return (p["x"], p["ln_scale"], p["ln_bias"], wf["q"], wf["scale"], p["b_fc"],
            wp["q"], wp["scale"], p["b_proj"], wf["qt"], wp["qt"])


def _k1_library(p, heads):
    """LN + qkv + attention + out-projection + residual from library calls."""
    import torch.nn.functional as F

    x = p["x"]
    b, n, d = x.shape
    w_qkv_t, w_out_t = p["w_qkv_t"], p["w_out_t"]
    h = F.layer_norm(x, (d,), p["ln_scale"].to(x.dtype), p["ln_bias"].to(x.dtype))
    qkv = F.linear(h, w_qkv_t, p["b_qkv"])
    q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2) for t in qkv.split(d, -1))
    mask = None if p["mask"] is None else p["mask"].to(x.dtype)
    attn = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return x + F.linear(attn.transpose(1, 2).reshape(b, n, d), w_out_t,
                        p["b_out"])


def _k2_library(p):
    import torch
    import torch.nn.functional as F

    x = p["x"]
    d = x.shape[-1]
    h = F.layer_norm(x, (d,), p["ln_scale"].to(x.dtype), p["ln_bias"].to(x.dtype))
    hid = F.linear(h, p["w_fc_t"], p["b_fc"].to(x.dtype))
    hid = hid * torch.sigmoid(1.702 * hid)
    return x + F.linear(hid, p["w_proj_t"], p["b_proj"].to(x.dtype))


def _cost(kernel, b, n, d, itemsize, masked):
    """(FLOPs, bytes) the block must do and move: each input read once and
    the output written once. K8 is K1 without the LN parameters."""
    t = b * n
    act = 2 * t * d * itemsize  # x in, out
    if kernel in ("fused_ln_attention_block", "fused_attention_block"):
        flops = 8 * t * d * d + 4 * b * n * n * d
        weights = 4 * d * d * itemsize + (3 * d + d) * itemsize
        if kernel == "fused_ln_attention_block":
            weights += 2 * d * 4
        return flops, act + weights + (n * n * 4 if masked else 0)
    flops = 16 * t * d * d
    weights = 8 * d * d * itemsize + (4 * d + d) * 4 + 2 * d * 4
    return flops, act + weights


def _attention_cost(b, h, n, dh, itemsize, masked):
    """(FLOPs, bytes) of K7: q·kᵀ and p·v, q, k and v read once, the output
    written once, the fp32 mask read once."""
    return (4 * b * h * n * n * dh,
            4 * b * h * n * dh * itemsize + (n * n * 4 if masked else 0))


def _forward_cell(kernel, name, shape, dtype_name, runs, flops, nbytes, peaks):
    """One phase-2 cell: the kernel against its plain version at
    TOLERANCES, then the kernel, the plain version and the library yardstick
    timed. ``runs`` is (run_kernel, run_plain, run_library)."""
    import torch

    run_kernel, run_plain, run_library = runs
    atol, rtol = TOLERANCES[dtype_name]
    with torch.no_grad():
        out = run_kernel()
        ref = run_plain()
        torch.cuda.synchronize()
        max_abs, max_rel, worst, ok = compare_margin(out, ref, atol, rtol)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: non-finite output")
        del out, ref
        ms = time_ms(run_kernel)
        plain_ms = time_ms(run_plain)
        library_ms = time_ms(run_library)
    t_ops = flops / op_rate(peaks, dtype_name) * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    cell = {
        "name": name,
        "kernel": kernel,
        "route": "cuda",
        "source": KERNELS[kernel][0],
        "replaces": KERNELS[kernel][1],
        "shape": list(shape),
        "dtype": dtype_name,
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "worst_over_limit": worst,
        "tol": {"atol": atol, "rtol": rtol},
        "kernel_ms": ms,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    log(f"[kernels] {name}: max_abs_err {max_abs:.3e} max_rel_err "
        f"{max_rel:.3e} worst/limit {worst:.3f} (tol atol {atol:.3e} rtol "
        f"{rtol:.3e}) kernel_ms "
        f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"bound_ms {cell['bound_ms']:.4f} ({cell['bound_by']})")
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           "past the tolerance")
    return cell


def phase_kernels(device, peaks):
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    cells = []
    for shape_name, b, n, d, heads, causal, dtype_names in SHAPES:
        for dtype_name in dtype_names:
            dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
            p = _block_inputs(b, n, d, causal, dtype, device, seed=len(cells))
            for key in ("w_qkv", "w_out", "w_fc", "w_proj"):
                p[key + "_t"] = p[key].t().contiguous()  # F.linear layout
            k1 = _block_args("fused_ln_attention_block", p, heads)
            k2 = _block_args("fused_ln_mlp", p, heads)
            runs = {
                "fused_ln_attention_block": (
                    lambda: fa.fused_ln_attention_block(*k1),
                    lambda: fa.ln_attention_block_plain(*k1),
                    lambda: _k1_library(p, heads),
                ),
                "fused_ln_mlp": (
                    lambda: fa.fused_ln_mlp(*k2),
                    lambda: fa.ln_mlp_plain(*k2),
                    lambda: _k2_library(p),
                ),
            }
            for kernel, kernel_runs in runs.items():
                flops, nbytes = _cost(kernel, b, n, d, p["x"].element_size(),
                                      causal)
                cells.append(_forward_cell(
                    kernel, f"{kernel}[{shape_name},B={b},{dtype_name}]",
                    (b, n, d, heads), dtype_name, kernel_runs, flops, nbytes,
                    peaks))
            del p, k1, k2, runs
    return cells


def _k8_library(p, heads):
    """qkv projection, attention and out-projection from library calls."""
    import torch.nn.functional as F

    h = p["x"]
    b, n, d = h.shape
    qkv = F.linear(h, p["w_qkv_t"], p["b_qkv"])
    q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2) for t in qkv.split(d, -1))
    attn = F.scaled_dot_product_attention(q, k, v)
    return F.linear(attn.transpose(1, 2).reshape(b, n, d), p["w_out_t"], p["b_out"])


def phase_attention_kernels(device, peaks):
    """K7 and K8 cells: kernel vs plain, timed beside the plain version and
    the library yardstick (SDPA for K7)."""
    import torch
    import torch.nn.functional as F

    from clip_gp_tpu_torch.ops import flash_attention as fa

    cells = []
    for shape_name, b, heads, n, dh, causal, dtype_names in K7_SHAPES:
        for dtype_name in dtype_names:
            dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
            g = torch.Generator().manual_seed(400 + len(cells))
            q, k, v = (torch.randn(b, heads, n, dh, generator=g).to(device, dtype)
                       for _ in range(3))
            mask = (torch.triu(torch.full((n, n), float("-inf"), device=device), 1)
                    if causal else None)
            runs = (lambda: fa.flash_attention(q, k, v, mask),
                    lambda: fa.attention_plain(q, k, v, mask),
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=causal))
            flops, nbytes = _attention_cost(b, heads, n, dh, q.element_size(),
                                            causal)
            cells.append(_forward_cell(
                "flash_attention",
                f"flash_attention[{shape_name},B={b},H={heads},N={n},Dh={dh},"
                f"{dtype_name}]", (b, heads, n, dh), dtype_name, runs, flops,
                nbytes, peaks))
            del q, k, v, runs
    for shape_name, b, n, d, heads in K8_SHAPES:
        for dtype_name in ("fp32", "bf16"):
            dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
            p = _block_inputs(b, n, d, False, dtype, device, seed=500 + len(cells))
            for key in ("w_qkv", "w_out"):
                p[key + "_t"] = p[key].t().contiguous()
            args = _block_args("fused_attention_block", p, heads)
            runs = (lambda: fa.fused_attention_block(*args),
                    lambda: fa.attention_block_plain(*args),
                    lambda: _k8_library(p, heads))
            flops, nbytes = _cost("fused_attention_block", b, n, d,
                                  p["x"].element_size(), False)
            cells.append(_forward_cell(
                "fused_attention_block",
                f"fused_attention_block[{shape_name},B={b},{dtype_name}]",
                (b, n, d, heads), dtype_name, runs, flops, nbytes, peaks))
            del p, args, runs
        torch.cuda.empty_cache()
    return cells


def _sweep_mask(kind, n, device, g):
    """No mask, a causal mask or a random finite additive fp32 mask."""
    import torch

    if kind == "none":
        return None
    if kind == "causal":
        return torch.triu(torch.full((n, n), float("-inf")), 1).to(device)
    return (2 * torch.randn(n, n, generator=g)).to(device)


def phase_core_sweep(device, batch=2, heads=3, width=128, block_heads=2):
    """The attention core shared by K1, K5, K7 and K8 against the plain
    versions, untimed: K7 at every CORE_SWEEP_N, both head widths and dtypes
    and the three masks of ``_sweep_mask``; K1, K5 and K8 at CORE_BLOCK_N,
    without a mask and causal, at a small width. Prints the largest error of
    each group and raises past the tolerances (TOLERANCES; Q8_TOL for K5)."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa
    from clip_gp_tpu_torch.ops import int8_block as ib

    def check(group, dtype_name, what, out, ref):
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(ref.shape) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"core sweep {what}: bad output {tuple(out.shape)}")
        if group.startswith("K5"):
            max_abs, outside, mean_rel, ok = _q8_compare(out, ref)
            errs = (max_abs, outside, mean_rel)
        else:
            max_abs, max_rel, ok = compare(out, ref, *TOLERANCES[dtype_name])
            errs = (max_abs, max_rel)
        if not ok:
            raise RuntimeError(f"core sweep {what}: kernel disagrees with its "
                               f"plain version past the tolerance {errs}")
        if errs > worst.get(group, ((-1.0,), ""))[0]:
            worst[group] = (errs, what)

    worst = {}  # group -> (errors, where)
    with torch.no_grad():
        for dtype_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for dh in (32, 64):
                for n in CORE_SWEEP_N:
                    for kind in CORE_SWEEP_MASKS:
                        g = torch.Generator().manual_seed(700 + n)
                        q, k, v = (torch.randn(batch, heads, n, dh, generator=g)
                                   .to(device, dtype) for _ in range(3))
                        mask = _sweep_mask(kind, n, device, g)
                        check(f"K7 {dtype_name} Dh={dh} mask={kind}", dtype_name,
                              f"N={n}", fa.flash_attention(q, k, v, mask),
                              fa.attention_plain(q, k, v, mask))
            for n in CORE_BLOCK_N:
                for causal in (False, True):
                    what = f"N={n}{' causal' if causal else ''}"
                    p = _block_inputs(batch, n, width, causal, dtype, device,
                                      seed=800 + n)
                    k1 = _block_args("fused_ln_attention_block", p, block_heads)
                    check(f"K1 {dtype_name}", dtype_name, what,
                          fa.fused_ln_attention_block(*k1),
                          fa.ln_attention_block_plain(*k1))
                    k8 = _block_args("fused_attention_block", p, block_heads)
                    check(f"K8 {dtype_name}", dtype_name, what,
                          fa.fused_attention_block(*k8),
                          fa.attention_block_plain(*k8))
                    p = _q8_block_inputs(batch, n, width, dtype_name, device,
                                         seed=800 + n, causal=causal)
                    k5 = _block_args("q8_ln_attention_block", p, block_heads)
                    check(f"K5 {dtype_name}", dtype_name, what,
                          ib.q8_ln_attention_block(*k5),
                          ib.q8_ln_attention_block_plain(*k5))
    for group, (errs, what) in worst.items():
        kind = ("max_abs_err {:.3e} share outside tol {:.2e} mean_rel_err {:.3e}"
                if group.startswith("K5") else "max_abs_err {:.3e} max_rel_err {:.3e}")
        log(f"[core sweep] {group}: largest error at {what}: " + kind.format(*errs))
    log(f"[core sweep] {len(worst)} groups within tolerance")


def _tile_names():
    """The three tile shapes of the 3xTF32 core, by the names the sweeps
    print."""
    from clip_gp_tpu_torch.ops import flash_attention as fa

    return {"128x128": fa._TILE_128, "128x64": fa._TILE_128X64,
            "64x64": fa._TILE_64}


def _gemm_direct(lib, p, epilogue, tile=None):
    """One launch of ln_gemm.cu's product with ``epilogue`` on ``p``'s a, w,
    bias (and resid), after the LN pass over a with gamma and beta for the
    qkv and c_fc epilogues; ``tile`` forces an fp32 tile shape."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    a = p["a"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    out = torch.empty(a.shape[0], p["w"].shape[1], dtype=a.dtype, device=a.device)
    if epilogue in ("qkv", "gelu"):
        a = fa._ln_input(lib, a, p["gamma"], p["beta"], stream)
    fa._gemm(lib, a, p["w"], p["bias"], out, fa.GEMM_EPILOGUES.index(epilogue),
             stream, resid=p["resid"] if epilogue.startswith("resid") else None,
             tile=tile)
    return out


def phase_gemm_sweep(device, heads=3, width=192, mlp_width=200):
    """The GEMM shared by K1, K2 and K8 against its plain version, untimed,
    in bf16 and in fp32 with each tile shape, at the shapes of
    GEMM_SWEEP_ROWS, GEMM_SWEEP_KN and GEMM_SWEEP_BLOCKS; prints the largest
    error of each dtype, epilogue and block and raises past TOLERANCES. Then
    times the fp32 products of GEMM_TILE_CELLS with each tile shape."""
    import torch

    from clip_gp_tpu_torch.ops import _build
    from clip_gp_tpu_torch.ops import flash_attention as fa

    worst = {}  # group -> ((max_abs, max_rel), where, dtype name)

    def check(group, dtype_name, what, out, ref):
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(ref.shape) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"gemm sweep {group} {what}: bad output")
        max_abs, max_rel, ok = compare(out, ref, *TOLERANCES[dtype_name])
        if not ok:
            raise RuntimeError(f"gemm sweep {group} {what}: kernel disagrees with "
                               f"its plain version past the tolerance "
                               f"({max_abs:.3e}, {max_rel:.3e})")
        if (max_abs, max_rel) > worst.get(group, ((-1.0, -1.0),))[0]:
            worst[group] = ((max_abs, max_rel), what, dtype_name)

    lib = _build.library()
    tiles = _tile_names()
    with torch.no_grad():
        for dtype_name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            # bf16 has one tile shape
            shapes = {"": None} if dtype_name == "bf16" else {
                f" tile {name}": tile for name, tile in tiles.items()}
            for m in GEMM_SWEEP_ROWS:
                for k, n in GEMM_SWEEP_KN:
                    g = torch.Generator().manual_seed(1000 + m + k)

                    def rnd(*shape, scale=1.0):
                        return (torch.randn(*shape, generator=g) * scale).to(device)

                    p = {"a": rnd(m, k).to(dtype),
                         "w": rnd(k, n, scale=k**-0.5).to(dtype),
                         "bias": 0.1 * rnd(n), "resid": rnd(m, n).to(dtype),
                         "gamma": 1 + 0.1 * rnd(k), "beta": 0.1 * rnd(k)}
                    for epi in fa.GEMM_EPILOGUES:
                        ln = epi in ("qkv", "gelu")
                        ref = fa.gemm_plain(p["a"], p["w"], p["bias"], epi,
                                            resid=p["resid"],
                                            ln_scale=p["gamma"] if ln else None,
                                            ln_bias=p["beta"] if ln else None)
                        for shape_name, tile in shapes.items():
                            check(f"{dtype_name} epilogue {epi}{shape_name}",
                                  dtype_name, f"M={m},K={k},N={n}",
                                  _gemm_direct(lib, p, epi, tile), ref)
            for b, n in GEMM_SWEEP_BLOCKS:
                what = f"B={b},N={n}"
                p = _block_inputs(b, n, width, False, dtype, device, seed=1100 + n)
                k1 = _block_args("fused_ln_attention_block", p, heads)
                check(f"{dtype_name} K1 (qkv, resid_attn)", dtype_name, what,
                      fa.fused_ln_attention_block(*k1),
                      fa.ln_attention_block_plain(*k1))
                k8 = _block_args("fused_attention_block", p, heads)
                check(f"{dtype_name} K8 (bias, bias)", dtype_name, what,
                      fa.fused_attention_block(*k8), fa.attention_block_plain(*k8))
                p = _block_inputs(b, n, mlp_width, False, dtype, device,
                                  seed=1200 + n)
                k2 = _block_args("fused_ln_mlp", p, heads)
                check(f"{dtype_name} K2 (gelu, resid_mlp)", dtype_name, what,
                      fa.fused_ln_mlp(*k2), fa.ln_mlp_plain(*k2))
    for group, ((max_abs, max_rel), what, dtype_name) in worst.items():
        atol, rtol = TOLERANCES[dtype_name]
        log(f"[gemm sweep] {group}: largest error at {what}: max_abs_err "
            f"{max_abs:.3e} max_rel_err {max_rel:.3e} (tol atol {atol:.3e} "
            f"rtol {rtol:.3e})")
    log(f"[gemm sweep] {len(worst)} groups within tolerance")
    phase_gemm_tiles(device, lib, tiles)


def phase_gemm_tiles(device, lib, tiles):
    """Each fp32 forward product of GEMM_TILE_CELLS timed with each tile
    shape, beside the one ``_tile_plan`` picks (A read as is: the LN pass is
    not timed)."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    names = {v: k for k, v in tiles.items()}
    sms = fa._sm_count(device.index or 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    g = torch.Generator(device=device).manual_seed(1300)
    with torch.no_grad():
        for shape, m, product, n, k, epi in GEMM_TILE_CELLS:
            a = torch.randn(m, k, device=device, generator=g)
            w = torch.randn(k, n, device=device, generator=g) * k**-0.5
            bias = 0.1 * torch.randn(n, device=device, generator=g)
            resid = (torch.randn(m, n, device=device, generator=g)
                     if epi.startswith("resid") else None)
            out = torch.empty(m, n, device=device)
            code = fa.GEMM_EPILOGUES.index(epi)
            times = {name: time_ms(lambda: fa._gemm(lib, a, w, bias, out, code, stream,
                                                    resid=resid, tile=tile))
                     for name, tile in tiles.items()}
            flops = 2 * m * n * k
            log(f"[gemm tiles] {product} {shape} M={m} N={n} K={k} fp32: " + ", ".join(
                f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
                for name, ms in times.items()) + f"; plan {names[fa._tile_plan(m, n, sms)]}")
            del a, w, bias, resid, out
    torch.cuda.empty_cache()


def _gemm_bwd_operands(op, m, n, k, dtype, device, seed):
    """The operands of one backward product ``op``: out [m, n], a sum over
    k; x or dout (the io operand) in ``dtype``."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    p = {"bias": 0.1 * rnd(n), "aux": rnd(m, n)}
    if op == "ln_nn_bias":
        p["a"], p["b"] = rnd(m, k), rnd(k, n, scale=k**-0.5)
    elif op in ("nt", "nt_gelu_bwd"):
        p["a"], p["b"] = rnd(m, k), rnd(n, k, scale=k**-0.5)
    else:
        p["a"], p["b"] = rnd(k, m), rnd(k, n, scale=k**-0.5)
    io = "b" if op in ("tn", "gelu_tn") else "a"
    p[io] = p[io].to(dtype)
    width = p["a"].shape[1]
    p["ln_scale"], p["ln_bias"] = 1 + 0.1 * rnd(width), 0.1 * rnd(width)
    return p


def _gemm_bwd_direct(lib, op, p, tile=None, act=None):
    """One launch of ``op``'s product of gemm_bwd.cu on ``p``, after the pass
    that writes its A (LN(x) by the port's LN pass; QuickGELU(hid_pre),
    which K4's hid_pre product writes, here from PyTorch). ``tile`` forces
    the tile shape (the split stays the plan's)."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    a, b = p["a"], p["b"]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if op in ("ln_nn_bias", "ln_tn"):
        a = fa._ln_f32(lib, a, p["ln_scale"], p["ln_bias"], stream)[1]
    elif op == "gelu_tn":
        a = fa.quick_gelu(a)
    product = fa.GEMM_BWD_OPS[op]
    if product == "tn":
        (k, m), n = a.shape, b.shape[1]
    else:
        (m, k), n = a.shape, b.shape[1 if product == "nn_bias" else 0]
    plan = fa._gemm_bwd_plan(m, n, k, product, fa._sm_count(a.device.index or 0))
    return fa._gemm_bwd(lib, product, a, b, m, n, k, stream,
                        bias=p["bias"] if product == "nn_bias" else None,
                        aux=p["aux"] if product == "nt_gelu_bwd" else None,
                        act=act, plan=plan if tile is None else (tile, plan[1]))


def phase_gemm_bwd_sweep(device):
    """The 3xTF32 GEMM core of K3 and K4 against gemm_bwd_plain, untimed, at
    the shapes of GEMM_BWD_SWEEP_*: prints the largest error of each product
    and io dtype and raises past BWD_RTOL; then times the dx products of
    GEMM_BWD_TILE_CELLS with each tile shape."""
    import torch

    from clip_gp_tpu_torch.ops import _build
    from clip_gp_tpu_torch.ops import flash_attention as fa

    lib = _build.library()
    tiles = _tile_names()
    worst = {}  # group -> (max_rel, max_abs, where)
    for op in fa.GEMM_BWD_OPS:
        for dtype_name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            group = f"{op} {dtype_name}"
            for m in GEMM_BWD_SWEEP_ROWS:
                for n in GEMM_BWD_SWEEP_N:
                    for k in GEMM_BWD_SWEEP_K:
                        p = _gemm_bwd_operands(op, m, n, k, dtype, device,
                                               seed=2000 + m + n + k)
                        ref = fa.gemm_bwd_plain(op, p["a"], p["b"], bias=p["bias"],
                                                aux=p["aux"], ln_scale=p["ln_scale"],
                                                ln_bias=p["ln_bias"])
                        checks = []
                        for tile_name, tile in tiles.items():
                            act = (torch.empty(m, n, device=device)
                                   if op == "ln_nn_bias" else None)
                            out = _gemm_bwd_direct(lib, op, p, tile, act)
                            checks.append((tile_name, out, ref))
                            if act is not None:
                                checks.append((tile_name + " act", act,
                                               fa.quick_gelu(ref)))
                        torch.cuda.synchronize()
                        for what, out, expected in checks:
                            where = f"M={m},N={n},K={k},{what}"
                            if not bool(torch.isfinite(out).all()):
                                raise RuntimeError(f"gemm_bwd sweep {group} {where}: "
                                                   "non-finite output")
                            max_abs, max_rel, ok = _compare_grads([out], [expected])
                            if not ok:
                                raise RuntimeError(
                                    f"gemm_bwd sweep {group} {where}: kernel disagrees "
                                    f"with its plain version past the tolerance "
                                    f"({max_abs:.3e}, {max_rel:.3e})")
                            if max_rel > worst.get(group, (-1.0,))[0]:
                                worst[group] = (max_rel, max_abs, where)
    for group, (max_rel, max_abs, where) in worst.items():
        log(f"[gemm_bwd sweep] {group}: largest error at {where}: max_abs_err "
            f"{max_abs:.3e} max_rel_err {max_rel:.3e} (tol {BWD_RTOL['fp32']} x "
            f"(max|plain| + |plain|))")
    log(f"[gemm_bwd sweep] {len(worst)} groups within tolerance")
    sms = fa._sm_count(device.index or 0)
    names = {v: k for k, v in tiles.items()}
    for op, t, n, k in GEMM_BWD_TILE_CELLS:
        p = _gemm_bwd_operands(op, t, n, k, torch.float32, device, seed=2100)
        times = {name: time_ms(lambda: _gemm_bwd_direct(lib, op, p, tile))
                 for name, tile in tiles.items()}
        plan = fa._gemm_bwd_plan(t, n, k, fa.GEMM_BWD_OPS[op], sms)
        flops = 2 * t * n * k
        log(f"[gemm_bwd tiles] {op} M={t} N={n} K={k} fp32: " + ", ".join(
            f"{name} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
            for name, ms in times.items()) + f"; plan {names[plan[0]]}")
        del p
    torch.cuda.empty_cache()


def phase_attention_bwd_sweep(device, batch=2, heads=2):
    """The attention-core backward of K3 (``_attention_bwd``) against
    ``attention_bwd_plain``, untimed: random fp32 qkv and d_attn at every
    ATTN_BWD_SWEEP_N under each mask of ``_sweep_mask``, with the head
    outputs and without (dqkv alone, as the dx-only call asks). Prints the
    largest error over its limit (BWD_RTOL of max|plain| + |plain|) per mask
    and raises past it."""
    import torch

    from clip_gp_tpu_torch.ops import _build
    from clip_gp_tpu_torch.ops import flash_attention as fa

    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    d = heads * fa.HEAD_DIM
    worst = {}  # mask -> (error over limit, max abs error, where)
    with torch.no_grad():
        for n in ATTN_BWD_SWEEP_N:
            for kind in CORE_SWEEP_MASKS:
                g = torch.Generator().manual_seed(1000 + n)
                qkv = torch.randn(batch * n, 3 * d, generator=g).to(device)
                d_attn = torch.randn(batch * n, d, generator=g).to(device)
                mask = _sweep_mask(kind, n, device, g)
                dqkv_ref, attn_ref = fa.attention_bwd_plain(
                    qkv.view(batch, n, 3 * d), d_attn.view(batch, n, d), mask, heads)
                for with_attn in (True, False):
                    dqkv, attn = fa._attention_bwd(lib, qkv, d_attn, mask, batch, n,
                                                   heads, d, stream, with_attn)
                    torch.cuda.synchronize()
                    pairs = [(dqkv, dqkv_ref.reshape(batch * n, 3 * d))]
                    if with_attn:
                        pairs.append((attn, attn_ref.reshape(batch * n, d)))
                    for name, (out, ref) in zip(("dqkv", "attn"), pairs):
                        if not bool(torch.isfinite(out).all()):
                            raise RuntimeError(f"attention_bwd sweep N={n} "
                                               f"mask={kind}: non-finite {name}")
                        diff = (out - ref).abs()
                        over = (diff / (BWD_RTOL["fp32"] * (ref.abs().max()
                                                          + ref.abs()))).max().item()
                        what = f"N={n} {name}{'' if with_attn else ' (dx only)'}"
                        if over > 1.0:
                            raise RuntimeError(
                                f"attention_bwd sweep {what} mask={kind}: kernel "
                                f"disagrees with its plain version, error "
                                f"{over:.3f} of its limit")
                        if over > worst.get(kind, (-1.0,))[0]:
                            worst[kind] = (over, diff.max().item(), what)
    for kind, (over, max_abs, what) in worst.items():
        log(f"[attention_bwd sweep] mask={kind}: largest error at {what}: "
            f"{over:.4f} of its limit (max_abs_err {max_abs:.3e})")
    log(f"[attention_bwd sweep] {len(ATTN_BWD_SWEEP_N)} sequence lengths x "
        f"{len(CORE_SWEEP_MASKS)} masks within tolerance")


def _short_kernel_name(name: str) -> str:
    """A CUDA kernel's demangled name without its namespaces, return type and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name if len(name) <= 90 else name[:87] + "..."


def phase_profile(device, b=512, n=197, d=768, heads=12, calls=3):
    """``torch.profiler`` (CUDA activity) over ``calls`` calls each of K1,
    K2 and K8 at ViT-B/16 B=512 in bf16 and fp32, of K5 and K6 in bf16 and
    of K3 and K4 (dx only, and with every gradient) in fp32 at the trimmed text
    tower's CoCoOp chunk, after a warm-up call: prints the device time of
    each CUDA kernel by name, per call, with the number of launches the trace
    holds of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_gp_tpu_torch.ops import flash_attention as fa
    from clip_gp_tpu_torch.ops import int8_block as ib

    def profiled(label, run, shape=f"ViT-B/16 B={b}"):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        times, counts = {}, {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            key = _short_kernel_name(evt.key)
            times[key] = times.get(key, 0.0) + us / calls
            counts[key] = counts.get(key, 0) + evt.count
        total = sum(times.values())
        if not total:
            raise RuntimeError(f"profile {label}: the trace holds no device time")
        parts = "; ".join(f"{key} {us / 1e3:.4f} ms ({100 * us / total:.1f}%, "
                          f"{counts[key]} launches)"
                          for key, us in sorted(times.items(), key=lambda kv: -kv[1]))
        log(f"[profile] {label} {shape}: device time per call "
            f"{total / 1e3:.4f} ms over {calls} calls: {parts}")
        return times

    with torch.no_grad():
        for dtype_name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            p = _block_inputs(b, n, d, False, dtype, device, seed=900)
            args = _block_args("fused_ln_attention_block", p, heads)
            profiled(f"K1 {dtype_name}", lambda: fa.fused_ln_attention_block(*args))
            args = _block_args("fused_ln_mlp", p, heads)
            profiled(f"K2 {dtype_name}", lambda: fa.fused_ln_mlp(*args))
            args = _block_args("fused_attention_block", p, heads)
            profiled(f"K8 {dtype_name}", lambda: fa.fused_attention_block(*args))
            if dtype_name == "bf16":
                del p, args
                p = _q8_block_inputs(b, n, d, dtype_name, device, seed=900)
                args = _block_args("q8_ln_attention_block", p, heads)
                profiled("K5 bf16", lambda: ib.q8_ln_attention_block(*args))
                args = _block_args("q8_ln_mlp", p, heads)
                profiled("K6 bf16", lambda: ib.q8_ln_mlp(*args))
            del p, args
            torch.cuda.empty_cache()
    # K3 and K4 as a CoCoOp chunk launches them (dx only), and with every
    # gradient
    p = _block_inputs(256, 24, 512, True, torch.float32, device, seed=901)
    dout = torch.randn(256, 24, 512, generator=torch.Generator().manual_seed(902))
    dout = dout.to(device)
    for param_grads, grads in ((False, "dx"), (True, "all")):
        times = profiled(f"K3 fp32 {grads}", lambda: fa.ln_attn_bwd(
            p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"], p["b_qkv"], p["w_out"],
            p["mask"], 8, dout, param_grads=param_grads), shape="text B=256 N=24")
        # the attention backward's own kernels against their bound
        attn_us = sum(us for key, us in times.items() if "attn_bwd" in key)
        flops, nbytes = _attention_bwd_cost(256, 24, 512, param_grads)
        t_ops = flops / op_rate(card_peaks(torch.cuda.get_device_name(0)), "fp32")
        t_bytes = nbytes / card_peaks(torch.cuda.get_device_name(0))["bytes"]
        bound_ms = max(t_ops, t_bytes) * 1e3
        log(f"[profile] K3 fp32 {grads} text B=256 N=24: attention backward "
            f"{attn_us / 1e3:.4f} ms per call, bound {bound_ms:.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: {nbytes / 1e6:.1f} "
            f"MB, {flops / 1e9:.2f} GFLOP), {100 * bound_ms * 1e3 / attn_us:.1f}% "
            f"of it")
        profiled(f"K4 fp32 {grads}", lambda: fa.ln_mlp_bwd(
            p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"], p["b_fc"], p["w_proj"],
            dout, param_grads=param_grads), shape="text B=256 N=24")


def _attention_bwd_cost(b, n, d, with_attn):
    """(FLOPs, bytes) of K3's attention-core backward: qkv, d_attn and the
    mask read once, dqkv (and the head outputs) written once, fp32; six
    products of 2·B·N²·D FLOPs each."""
    nbytes = 4 * (b * n * (3 + 1 + 3 + (1 if with_attn else 0)) * d + n * n)
    return 12 * b * n * n * d, nbytes


def _bwd_cost(kernel, b, n, d, itemsize, param_grads):
    """(FLOPs, bytes) of one backward call: x and dout read once, the
    weights once, dx (and with ``param_grads`` every parameter gradient)
    written once. The math is fp32 whatever x's type."""
    t = b * n
    act = 3 * t * d * itemsize  # x, dout in; dx out
    if kernel == "ln_attn_bwd":
        flops = (22 if param_grads else 14) * t * d * d + 12 * b * n * n * d
        params = 4 * d * d * itemsize + 3 * d * itemsize + 2 * d * 4
        extra = n * n * 4  # the mask
        grads = params + d * 4  # ... and db_out, fp32
    else:
        flops = (40 if param_grads else 24) * t * d * d
        params = 8 * d * d * itemsize + 4 * d * 4 + 2 * d * 4
        extra = 0
        grads = params + d * 4  # ... and db_proj, fp32
    return flops, act + params + extra + (grads if param_grads else 0)


def _compare_grads(got, ref):
    """(max abs error, max error relative to max|ref| + |ref|, every error
    within BWD_RTOL of that) over the gradients compared."""
    import torch

    max_abs = max_rel = 0.0
    ok = True
    for out, expected in zip(got, ref):
        rtol = BWD_RTOL["bf16" if out.dtype == torch.bfloat16 else "fp32"]
        out, expected = out.float(), expected.float()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("non-finite gradient")
        diff = (out - expected).abs()
        limit = (expected.abs().max() + expected.abs()).clamp_min(1e-30)
        max_abs = max(max_abs, diff.max().item())
        max_rel = max(max_rel, (diff / limit).max().item())
        ok = ok and bool((diff <= rtol * limit).all())
    return max_abs, max_rel, ok


def _bwd_library(kernel, p, heads, param_grads):
    """The block's forward from library calls, recorded by autograd once;
    returns a function that runs only its backward (the yardstick: PyTorch
    keeps the forward's activations, the kernels recompute them)."""
    import torch

    names = (["x", "ln_scale", "ln_bias", "w_qkv_t", "b_qkv", "w_out_t", "b_out"]
             if kernel == "ln_attn_bwd" else
             ["x", "ln_scale", "ln_bias", "w_fc_t", "b_fc", "w_proj_t", "b_proj"])
    q = dict(p)
    leaves = []
    for name in names if param_grads else ["x"]:
        q[name] = p[name].detach().clone().requires_grad_(True)
        leaves.append(q[name])
    with torch.enable_grad():
        out = _k1_library(q, heads) if kernel == "ln_attn_bwd" else _k2_library(q)
    dout = p["dout"]
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def phase_bwd_kernels(device, peaks):
    """K3/K4 cells: kernel vs plain on all seven gradients, timed dx-only
    and with every gradient."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    cells = []
    for shape_name, b, n, d, heads, dtype_name, kernels in BWD_SHAPES:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
        p = _block_inputs(b, n, d, True, dtype, device, seed=100 + len(cells))
        p["dout"] = torch.randn(b, n, d, generator=torch.Generator().manual_seed(
            len(cells))).to(device, dtype)
        for key in ("w_qkv", "w_out", "w_fc", "w_proj"):
            p[key + "_t"] = p[key].t().contiguous()
        args = {
            "ln_attn_bwd": (p["x"], p["ln_scale"], p["ln_bias"], p["w_qkv"],
                            p["b_qkv"], p["w_out"], p["mask"], heads, p["dout"]),
            "ln_mlp_bwd": (p["x"], p["ln_scale"], p["ln_bias"], p["w_fc"],
                           p["b_fc"], p["w_proj"], p["dout"]),
        }
        plain = {"ln_attn_bwd": fa.ln_attn_bwd_plain, "ln_mlp_bwd": fa.ln_mlp_bwd_plain}
        for kernel in kernels:
            a = args[kernel]
            run_plain = lambda: plain[kernel](*a)  # noqa: E731
            ref = run_plain()
            plain_ms = time_ms(run_plain)
            for param_grads in (False, True):
                run_kernel = lambda: getattr(fa, kernel)(  # noqa: E731
                    *a, param_grads=param_grads)
                got = run_kernel()
                torch.cuda.synchronize()
                max_abs, max_rel, ok = _compare_grads(
                    got if param_grads else got[:1], ref)
                ms = time_ms(run_kernel)
                library_ms = time_ms(_bwd_library(kernel, p, heads, param_grads))
                flops, nbytes = _bwd_cost(kernel, b, n, d, p["x"].element_size(),
                                          param_grads)
                t_ops = flops / op_rate(peaks, "fp32") * 1e3
                t_bytes = nbytes / peaks["bytes"] * 1e3
                grads = "all" if param_grads else "dx"
                cell = {
                    "name": f"{kernel}[text-{shape_name},B={b},N={n},{dtype_name},"
                            f"{grads}]",
                    "kernel": kernel,
                    "route": "cuda",
                    "source": KERNELS[kernel][0],
                    "replaces": KERNELS[kernel][1],
                    "shape": [b, n, d, heads],
                    "dtype": dtype_name,
                    "grads": grads,
                    "max_abs_err": max_abs,
                    "max_rel_err": max_rel,
                    "tol": {"of_max_plus_abs": BWD_RTOL},
                    "kernel_ms": ms,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                }
                log(f"[kernels] {cell['name']}: max_abs_err {max_abs:.3e} "
                    f"max_rel_err {max_rel:.3e} (tol {BWD_RTOL} x (max|plain| + "
                    f"|plain|)) kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                    f"library_ms {library_ms:.4f} bound_ms {cell['bound_ms']:.4f} "
                    f"({cell['bound_by']})")
                if not ok:
                    raise RuntimeError(f"{cell['name']}: kernel disagrees with "
                                       "its plain version past the tolerance")
                cells.append(cell)
        del p, args
    return cells


def _q8_block_inputs(b, n, d, dtype_name, device, seed, causal=False):
    """K5/K6 inputs: K1/K2's, with the four products quantized per output
    channel (``quantize_weight``), each with its K-major copy "qt" (as
    ``quantize_visual`` makes it) and, for the library yardstick, each int8
    weight also laid out column-major as ``torch._int_mm`` takes it."""
    import torch

    from clip_gp_tpu_torch.models.quantized import quantize_weight

    p = _block_inputs(b, n, d, causal, torch.float32, device, seed)
    p["x"] = p["x"].to({"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name])
    for key in ("w_qkv", "w_out", "w_fc", "w_proj"):
        p[key] = quantize_weight(p[key])
        p[key]["qt"] = p[key]["q"].t().contiguous()
    for key in ("w_qkv", "w_fc", "w_proj"):
        p[key]["cm"] = p[key]["qt"].t()
    dh = 64
    p["w_out"]["cm"] = [p["w_out"]["q"][i:i + dh].t().contiguous().t()
                        for i in range(0, d, dh)]
    return p


def _k5_library(p, heads):
    """K5's function from library calls: F.layer_norm, torch._int_mm for
    each product (one per head for the out-projection) and
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from clip_gp_tpu_torch.ops.int8_block import quantize_rows

    x = p["x"]
    b, n, d = x.shape
    dh = d // heads
    x32 = x.float().view(b * n, d)
    hq, hs = quantize_rows(F.layer_norm(x32, (d,), p["ln_scale"], p["ln_bias"]))
    wq, wo = p["w_qkv"], p["w_out"]
    qkv = (torch._int_mm(hq, wq["cm"]).float() * hs * wq["scale"]
           + p["b_qkv"].float()).to(x.dtype)
    q, k, v = (t.reshape(b, n, heads, dh).transpose(1, 2) for t in qkv.split(d, -1))
    attn = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        b * n, heads, dh)
    oq, os = quantize_rows(attn.float())
    acc = x32 + p["b_out"].float()
    for h in range(heads):
        acc = acc + (torch._int_mm(oq[:, h].contiguous(), wo["cm"][h]).float()
                     * os[:, h] * wo["scale"])
    return acc.to(x.dtype).view(b, n, d)


def _k6_library(p):
    import torch
    import torch.nn.functional as F

    from clip_gp_tpu_torch.ops.int8_block import quantize_rows

    x = p["x"]
    b, n, d = x.shape
    x32 = x.float().view(b * n, d)
    hq, hs = quantize_rows(F.layer_norm(x32, (d,), p["ln_scale"], p["ln_bias"]))
    wf, wp = p["w_fc"], p["w_proj"]
    hid = torch._int_mm(hq, wf["cm"]).float() * hs * wf["scale"] + p["b_fc"]
    gq, gs = quantize_rows(hid * torch.sigmoid(1.702 * hid))
    out = torch._int_mm(gq, wp["cm"]).float() * gs * wp["scale"] + p["b_proj"]
    return (x32 + out).to(x.dtype).view(b, n, d)


def _q8_compare(out, ref):
    """(max abs error, share of elements outside Q8_TOL's elementwise
    tolerance, mean |error| over mean |ref|, within Q8_TOL)."""
    diff = (out.float() - ref.float()).abs()
    limit = Q8_TOL["atol"] + Q8_TOL["rtol"] * ref.float().abs()
    outside = (diff > limit).float().mean().item()
    mean_rel = (diff.mean() / ref.float().abs().mean()).item()
    ok = outside <= 1 - Q8_TOL["share"] and mean_rel <= Q8_TOL["mean"]
    return diff.max().item(), outside, mean_rel, ok


def _q8_cost(kernel, b, n, d, itemsize, peaks):
    """(seconds of operations, bytes) of one K5/K6 call: int8 products at the
    int8 tensor peak, K5's attention core at the working type's peak; x read
    and the output written once, the int8 weights, their fp32 scales and
    the fp32 biases and LN parameters read once."""
    t = b * n
    act = 2 * t * d * itemsize
    if kernel == "q8_ln_attention_block":
        attn_peak = op_rate(peaks, "bf16" if itemsize == 2 else "fp32")
        seconds = 8 * t * d * d / peaks["int8"] + 4 * b * n * n * d / attn_peak
        return seconds, act + 4 * d * d + (3 * d + 3 * d + d + d + 2 * d) * 4
    seconds = 16 * t * d * d / peaks["int8"]
    return seconds, act + 8 * d * d + (4 * d + 4 * d + d + d + 2 * d) * 4


def phase_q8_kernels(device, peaks):
    """K5/K6 cells: kernel vs plain (share of elements within the tolerance
    and mean error), timed beside the plain version and the yardstick."""
    import torch

    from clip_gp_tpu_torch.ops import int8_block as ib

    cells = []
    for shape_name, b, n, d, heads, dtype_name in Q8_SHAPES:
        p = _q8_block_inputs(b, n, d, dtype_name, device, seed=200 + len(cells))
        k5 = _block_args("q8_ln_attention_block", p, heads)
        k6 = _block_args("q8_ln_mlp", p, heads)
        runs = {
            "q8_ln_attention_block": (
                lambda: ib.q8_ln_attention_block(*k5),
                lambda: ib.q8_ln_attention_block_plain(*k5),
                lambda: _k5_library(p, heads),
            ),
            "q8_ln_mlp": (
                lambda: ib.q8_ln_mlp(*k6),
                lambda: ib.q8_ln_mlp_plain(*k6),
                lambda: _k6_library(p),
            ),
        }
        for kernel, (run_kernel, run_plain, run_library) in runs.items():
            with torch.no_grad():
                out = run_kernel()
                ref = run_plain()
                lib_out = run_library()
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise RuntimeError(f"{kernel} {shape_name} {dtype_name}: "
                                       "non-finite output")
                max_abs, outside, mean_rel, ok = _q8_compare(out, ref)
                lib_rel = ((lib_out.float() - ref.float()).abs().mean()
                           / ref.float().abs().mean()).item()
                del out, ref, lib_out
                ms = time_ms(run_kernel)
                plain_ms = time_ms(run_plain)
                library_ms = time_ms(run_library)
            t_ops, nbytes = _q8_cost(kernel, b, n, d, p["x"].element_size(), peaks)
            t_ops *= 1e3
            t_bytes = nbytes / peaks["bytes"] * 1e3
            cell = {
                "name": f"{kernel}[{shape_name},B={b},{dtype_name}]",
                "kernel": kernel,
                "route": "cuda",
                "source": KERNELS[kernel][0],
                "replaces": KERNELS[kernel][1],
                "shape": [b, n, d, heads],
                "dtype": dtype_name,
                "max_abs_err": max_abs,
                "share_outside_tol": outside,
                "mean_rel_err": mean_rel,
                "library_mean_rel_err": lib_rel,
                "tol": Q8_TOL,
                "kernel_ms": ms,
                "ms": ms,
                "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            cell["bound_share"] = cell["bound_ms"] / ms
            log(f"[kernels] {cell['name']}: max_abs_err {max_abs:.3e} share "
                f"outside tol {outside:.2e} (allowed {1 - Q8_TOL['share']:.0e}) "
                f"mean_rel_err {mean_rel:.3e} (allowed {Q8_TOL['mean']:.0e}; "
                f"library {lib_rel:.3e}) kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
                f"{cell['bound_ms']:.4f} ({cell['bound_by']}, "
                f"{100 * cell['bound_share']:.1f}% of the kernel's time)")
            if not ok:
                raise RuntimeError(f"{cell['name']}: kernel disagrees with "
                                   "its plain version past the tolerance")
            cells.append(cell)
        del p, runs
        torch.cuda.empty_cache()
    return cells


def _q8_gemm_operands(m, n, k, groups, dtype, device, seed):
    """Random int8 A [M, K] and W [K, N] (the JAX layout), fp32 row scales
    [M, groups], column scales and bias [N], and a residual [M, N] in the
    working type, made on the card."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "a": torch.randint(-127, 128, (m, k), generator=g, device=device).to(torch.int8),
        "w": torch.randint(-127, 128, (k, n), generator=g, device=device).to(torch.int8),
        "row_scale": torch.rand(m, groups, generator=g, device=device) * 1e-2 + 1e-4,
        "col_scale": torch.rand(n, generator=g, device=device) * 1e-2 + 1e-4,
        "bias": 0.1 * torch.randn(n, generator=g, device=device),
        "resid": torch.randn(m, n, generator=g, device=device).to(dtype),
    }


def phase_q8_gemm(device, peaks, n_tokens=197, dtype_name="bf16"):
    """``[int8 gemm]`` cells: each product of K5 and K6 (Q8_GEMM_PRODUCTS)
    at ViT-B/16 B=32 and B=512 in the serving dtype, called through the
    wrapper's ``_q8_gemm`` with W's K-major copy made beforehand, as the int8
    tower makes it (the copy, which a call without it would make, is timed
    apart). Each is timed per call as every cell is (``time_ms``) and back
    to back (``time_ms_back_to_back``), beside its own bound and
    ``torch._int_mm`` on the same operands (int32 out, no scales or
    epilogue: a yardstick only, which the port never calls). At B=32 each
    is first held to ``q8_gemm_plain``: bit for bit, QuickGELU to the fp32
    tolerance."""
    import torch

    from clip_gp_tpu_torch.ops import _build
    from clip_gp_tpu_torch.ops import flash_attention as fa
    from clip_gp_tpu_torch.ops import int8_block as ib

    lib = _build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    with torch.no_grad():
        for b in (32, 512):
            m = b * n_tokens
            for product, n, k, epilogue, group_k in Q8_GEMM_PRODUCTS:
                groups = k // (group_k or k)
                p = _q8_gemm_operands(m, n, k, groups, dtype, device, seed=m + n)
                wt = p["w"].t().contiguous()
                out_dtype = torch.float32 if epilogue == "gelu" else dtype
                out = torch.empty(m, n, dtype=out_dtype, device=device)
                resid = p["resid"] if epilogue.startswith("resid") else None

                def run():
                    ib._q8_gemm(lib, p["a"], p["w"], p["row_scale"], p["col_scale"],
                                p["bias"], out, fa.GEMM_EPILOGUES.index(epilogue),
                                stream, group_k=group_k, resid=resid, wt=wt)

                if b == 32:
                    run()
                    ref = ib.q8_gemm_plain(p["a"], p["w"], p["row_scale"],
                                           p["col_scale"], p["bias"], epilogue,
                                           out_dtype, group_k=group_k, resid=resid)
                    torch.cuda.synchronize()
                    ok = (compare(out, ref, *TOLERANCES["fp32"])[2]
                          if epilogue == "gelu" else torch.equal(out, ref))
                    if not ok:
                        raise RuntimeError(f"int8 gemm {product} B={b}: kernel "
                                           "disagrees with q8_gemm_plain")
                    del ref
                ms = time_ms(run)
                b2b_ms = time_ms_back_to_back(run)
                w_cm = p["w"].t().contiguous().t()
                int_mm_ms = time_ms(lambda: torch._int_mm(p["a"], w_cm))
                copy_ms = time_ms(lambda: p["w"].t().contiguous())
                ops = 2 * m * n * k
                nbytes = (m * k + n * k + 4 * m * groups + 8 * n
                          + m * n * out.element_size()
                          + (m * n * resid.element_size() if resid is not None else 0))
                t_ops = ops / peaks["int8"] * 1e3
                t_bytes = nbytes / peaks["bytes"] * 1e3
                bound = max(t_ops, t_bytes)
                log(f"[int8 gemm] {product} ViT-B/16 B={b} M={m} N={n} K={k}"
                    f"{f' group_k={group_k}' if group_k else ''} {dtype_name}: "
                    f"kernel_ms {ms:.4f} ({ops / ms / 1e9:.1f} TOP/s; W's K-major "
                    f"copy, not in it, {copy_ms:.4f}) bound_ms {bound:.4f} "
                    f"({'operations' if t_ops >= t_bytes else 'bytes'}, "
                    f"{100 * bound / ms:.1f}% of the kernel's time; back to back "
                    f"{b2b_ms:.4f} ms, {100 * bound / b2b_ms:.1f}%) "
                    f"torch._int_mm {int_mm_ms:.4f} ms (kernel/int_mm "
                    f"{ms / int_mm_ms:.2f}x)")
                del p, out, resid, w_cm, wt
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_towers(device, backbone="ViT-B/16", n_images=32, n_prompts=256):
    import torch

    from clip_gp_tpu_torch.data.template_banks import IMAGENET_TEMPLATES
    from clip_gp_tpu_torch.models import clip_model
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params
    from clip_gp_tpu_torch.models.tokenizer import tokenize
    from clip_gp_tpu_torch.ops import flash_attention as fa

    arch = clip_model.ARCHITECTURES[backbone]
    model = init_clip_params(arch, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    res = arch.image_resolution
    images = torch.randn(n_images, res, res, 3, generator=g).to(device)
    names = ["red circle", "green square", "blue stripe", "yellow dot"]
    prompts = [t.format(c) for c in names for t in IMAGENET_TEMPLATES][:n_prompts]
    tokens = torch.from_numpy(tokenize(prompts)).to(device)

    def encode():
        with torch.no_grad():
            return model.encode_image(images), model.encode_text(tokens)

    img_k, txt_k = encode()
    # the same towers with every block on the plain versions
    with mock.patch.object(clip_model, "fused_ln_attention_block",
                           fa.ln_attention_block_plain), \
            mock.patch.object(clip_model, "fused_ln_mlp", fa.ln_mlp_plain):
        img_p, txt_p = encode()
    torch.cuda.synchronize()
    for what, out, ref, shape in (
        ("encode_image", img_k, img_p, (n_images, arch.embed_dim)),
        ("encode_text", txt_k, txt_p, (len(prompts), arch.embed_dim)),
    ):
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{what}: bad output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        log(f"[towers] {backbone} {what} {tuple(out.shape)} fp32: kernels vs "
            f"plain max_abs_err {err:.3e} (max |feature| {scale:.3f}; tol "
            f"{TOWER_TOL:.1e} x max |feature|)")
        if err > TOWER_TOL * scale:
            raise RuntimeError(f"{what}: kernel tower disagrees with the plain one")
    _tower_q8(model, arch, images, img_k, backbone)
    # a CoOp step's prompts in-process (K) and trial-batched in phase 11 (T x K)
    _tower_grad(model, device)
    _tower_grad(model, device, n_prompts=len(SWEEP_SEEDS) * SWEEP_COOP_CLASSES)
    del model


def _tower_q8(model, arch, images, fp32_features, backbone):
    """The int8 ViT tower (every block K5 then K6, bf16) against the same
    tower on the plain versions; its distance from the fp32 tower is printed
    (the weights are random, so it is no accuracy figure)."""
    import torch
    import torch.nn.functional as F

    from clip_gp_tpu_torch.models import quantized
    from clip_gp_tpu_torch.ops import int8_block as ib

    qvisual = quantized.quantize_visual(model, arch)
    ib.reset_launch_counts()
    got = quantized.encode_image_q8(qvisual, arch, images)
    launches = dict(ib.LAUNCHES)
    with mock.patch.object(ib, "q8_ln_attention_block", ib.q8_ln_attention_block_plain), \
            mock.patch.object(ib, "q8_ln_mlp", ib.q8_ln_mlp_plain):
        ref = quantized.encode_image_q8(qvisual, arch, images)
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(ref.shape) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"encode_image_q8: bad output {tuple(got.shape)}")
    cos = F.cosine_similarity(got, ref, dim=-1).min().item()
    cos_fp32 = F.cosine_similarity(got, fp32_features, dim=-1).min().item()
    log(f"[towers] {backbone} encode_image_q8 {tuple(got.shape)} bf16: kernels vs "
        f"plain min cosine {cos:.7f} (need >= {Q8_TOWER_COS}); vs the fp32 "
        f"tower min cosine {cos_fp32:.6f} (random weights, not gated); launches "
        f"{launches}")
    if cos < Q8_TOWER_COS:
        raise RuntimeError("encode_image_q8: kernel tower disagrees with the plain one")
    if min(launches.values()) < arch.vision_layers:
        raise RuntimeError(f"encode_image_q8: expected each kernel "
                           f"{arch.vision_layers} times, got {launches}")


def _tower_grad(model, device, n_prompts=100, n=24, n_images=32):
    """The gradient of a CoOp-shaped loss (cross-entropy of 100 x cosine
    logits over ``n_prompts`` prompts) with respect to the prompt
    embeddings, through K1-K4 and through every block's plain forward and
    plain backward, compared."""
    import torch
    import torch.nn.functional as F

    from clip_gp_tpu_torch.ops import flash_attention as fa

    arch = model.arch
    g = torch.Generator().manual_seed(2)
    embeds = (0.02 * torch.randn(n_prompts, n, arch.transformer_width,
                                 generator=g)).to(device)
    eot = torch.randint(8, n, (n_prompts,), generator=g).to(device)
    img = F.normalize(torch.randn(n_images, arch.embed_dim, generator=g), dim=-1)
    img = img.to(device)
    labels = torch.randint(0, n_prompts, (n_images,), generator=g).to(device)

    def grad():
        e = embeds.clone().requires_grad_(True)
        text = F.normalize(model.text_features_from_embeddings(e, eot), dim=-1)
        loss = F.cross_entropy(100.0 * img @ text.T, labels)
        return torch.autograd.grad(loss, e)[0]

    fa.reset_launch_counts()
    got = grad()
    launches = dict(fa.LAUNCHES)
    with mock.patch.object(fa, "_ln_attention_forward", fa.ln_attention_block_plain), \
            mock.patch.object(fa, "_ln_mlp_forward", fa.ln_mlp_plain), \
            mock.patch.object(fa, "ln_attn_bwd",
                              lambda *a, param_grads: fa.ln_attn_bwd_plain(*a)), \
            mock.patch.object(fa, "ln_mlp_bwd",
                              lambda *a, param_grads: fa.ln_mlp_bwd_plain(*a)):
        ref = grad()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("tower gradient: non-finite values")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"[towers] {arch.name} text-tower grad d(loss)/d(embeds) "
        f"{tuple(got.shape)} fp32: kernels vs plain max_abs_err {err:.3e} (max "
        f"|grad| {scale:.3e}; tol {TOWER_TOL:.1e} x max |grad|); launches "
        f"{launches}")
    if err > TOWER_TOL * scale:
        raise RuntimeError("tower gradient: kernels disagree with the plain versions")
    layers = arch.transformer_layers
    blocks = ("fused_ln_attention_block", "fused_ln_mlp", "ln_attn_bwd", "ln_mlp_bwd")
    if min(launches[k] for k in blocks) < layers:
        raise RuntimeError(f"tower gradient: expected each of {blocks} {layers} "
                           f"times, got {launches}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

class _ArrayLoader:
    """Batches of in-memory uint8 images, as BatchLoader yields them, over
    the split's items (``data_source``: the feature cache keys a split by
    its items' paths and labels)."""

    def __init__(self, images, labels, batch_size, items):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.data_source = items

    def __len__(self):
        return math.ceil(len(self.labels) / self.batch_size)

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            yield {"img": self.images[i:i + self.batch_size],
                   "label": self.labels[i:i + self.batch_size]}


class InMemoryDataManager:
    """The synthetic dataset's numpy images (``num_classes`` classes, "pattern
    c" past the first four) at full resolution, split per class into
    ``shots`` train images and the rest test, with no transform
    (INPUT.TRANSFORMS has no augmentation, so the test transform of a
    decoded image at the input size is the identity)."""

    def __init__(self, config, images_per_class, num_classes=4):
        import numpy as np

        from clip_gp_tpu_torch.data.datasets.synthetic import (
            synthetic_class_name,
            synthetic_images,
        )
        from clip_gp_tpu_torch.data.datum import DatasetBase, Datum

        shots = config.dataset.num_shots
        size = config.input.size[0]
        train, test = ([], []), ([], [])
        items = {"train": [], "test": []}
        for c, i, img in synthetic_images(num_classes, images_per_class, size,
                                          config.seed):
            split, arrays = ("train", train) if i < shots else ("test", test)
            arrays[0].append(img)
            arrays[1].append(c)
            # a path per generated image: the same path is the same pixels
            path = f"synthetic-{num_classes}x{images_per_class}-{size}px-seed{config.seed}/{c}/{i}"
            items[split].append(Datum(path, c, classname=synthetic_class_name(c)))
        self.dataset = DatasetBase(train_x=items["train"], test=items["test"])
        bs = config.dataloader.batch_size_train
        self.train_images = np.stack(train[0])
        self.train_labels = np.asarray(train[1], np.int32)
        self.train_loader_x = _ArrayLoader(self.train_images, self.train_labels, bs,
                                           items["train"])
        self.test_loader = _ArrayLoader(np.stack(test[0]), np.asarray(test[1], np.int32),
                                        config.dataloader.batch_size_test, items["test"])
        self.val_loader = None
        self.num_classes = self.dataset.num_classes
        self.lab2cname = self.dataset.lab2cname

    def eval_train_loader(self):
        return self.train_loader_x


def _config(backbone, trainer_name, shots, epochs):
    from clip_gp_tpu_torch.core.config import Config
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    c = Config()
    c.trainer_name = trainer_name
    c.dataset.name = "Synthetic"
    c.dataset.num_shots = shots
    arch = ARCHITECTURES[backbone]
    c.model.backbone_name = backbone
    c.input.size = (arch.image_resolution, arch.image_resolution)
    c.input.transforms = ["normalize"]
    c.dataloader.batch_size_train = 32
    c.dataloader.batch_size_test = 32
    c.adapter.clip_adapter_epochs = epochs
    c.optim.max_epoch = epochs
    c.train.print_freq = 1
    c.seed = 1
    return c, arch


def _reset_counts():
    from clip_gp_tpu_torch.ops import flash_attention as fa
    from clip_gp_tpu_torch.ops import int8_block as ib

    fa.reset_launch_counts()
    ib.reset_launch_counts()


def _counts():
    """Every kernel's launch count since the last ``_reset_counts``."""
    from clip_gp_tpu_torch.ops import flash_attention as fa
    from clip_gp_tpu_torch.ops import int8_block as ib

    return {**fa.LAUNCHES, **ib.LAUNCHES}


def _train(c, dm, on_build=None):
    """``build_trainer(c, dm).train()`` with the launch counts set to 0 just
    before and read just after: (launches, metrics, seconds, trainer).
    ``on_build`` sees the trainer right after its ``build_model``."""
    import numpy as np
    import torch

    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    import clip_gp_tpu_torch.methods  # noqa: F401  (registers the trainers)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        c.output_dir = out_dir
        set_random_seed(c.seed)
        trainer = build_trainer(c, dm)
        if on_build is not None:
            build = trainer.build_model

            def build_model():
                build()
                on_build(trainer)

            trainer.build_model = build_model
        _reset_counts()
        start = time.perf_counter()
        trainer.train()
        seconds = time.perf_counter() - start
        launches = _counts()
        with open(os.path.join(out_dir, "metrics.json")) as f:
            metrics = json.load(f)["metrics"]
    log(f"[{c.trainer_name}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # Tip-Adapter's metrics.json has no macro_f1, as in the JAX package
    for key in ("top1_acc", "ece", "aece") + (("macro_f1",) if "macro_f1" in metrics
                                              else ()):
        if not np.isfinite(metrics[key]):
            raise RuntimeError(f"{c.trainer_name} metrics.json: {key} = {metrics[key]}")
    return launches, metrics, seconds, trainer


def _check_launches(what, launches, need):
    log(f"[{what}] launches {launches} (need at least {need})")
    for name, count in need.items():
        if launches[name] < count:
            raise RuntimeError(f"{what}: {name} launched {launches[name]} times on "
                               f"the main path; expected at least {count}")


def _metrics_line(metrics):
    return " ".join(f"{key} {metrics[key]:.2f}" for key in
                    ("top1_acc", "macro_f1", "ece", "aece") if key in metrics)


def phase_trainer(backbone="ViT-B/16"):
    """The Adapter + GP flow; every frozen encode launches K1 and K2."""
    from clip_gp_tpu_torch.methods import common

    c, arch = _config(backbone, "Adapter", shots=4, epochs=3)
    c.adapter.use_gp = True
    c.adapter.num_templates = 16
    c.optim.name = "adamw"
    c.optim.lr = 1e-3
    dm = InMemoryDataManager(c, images_per_class=20)
    n_train, n_test = len(dm.dataset.train_x), len(dm.dataset.test)
    launches, metrics, seconds, _ = _train(c, dm)
    batch = common.extract_device_batch()
    image_encodes = math.ceil(n_test / batch) + math.ceil(n_train / batch)
    text_encodes = math.ceil(4 * c.adapter.num_templates / 256)
    need = (arch.vision_layers * image_encodes
            + arch.transformer_layers * text_encodes)
    log(f"[trainer] Adapter+GP {backbone}: {n_train} train / {n_test} test "
        f"images, {c.adapter.num_templates} templates, "
        f"{c.adapter.clip_adapter_epochs} epochs in {seconds:.2f} s; "
        f"{_metrics_line(metrics)}")
    _check_launches("trainer", launches, {"fused_ln_attention_block": need,
                                          "fused_ln_mlp": need})
    return launches


def _snapshot(trainer):
    """A copy of the trainer's parameters, flat."""
    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v.detach().clone()

    return dict(flat(trainer.params))


def _moved(before, trainer):
    """Largest change of each parameter since ``before``."""
    after = _snapshot(trainer)
    return {k: (after[k] - before[k]).abs().max().item() for k in before}


def phase_coop(backbone="ViT-B/16", classes=100):
    """Adapter-CoOp: every step encodes its images (K1/K2 through the image
    tower), then runs the text tower over the K prompts forward (K1/K2) and
    backward (K4/K3) in each of the 12 blocks."""
    c, arch = _config(backbone, "Adapter-CoOp", shots=4, epochs=2)
    c.adapter.n_ctx = 16
    dm = InMemoryDataManager(c, images_per_class=5, num_classes=classes)
    before = {}
    launches, metrics, seconds, trainer = _train(
        c, dm, on_build=lambda t: before.update(_snapshot(t)))
    steps = c.adapter.clip_adapter_epochs * len(dm.train_loader_x)
    moved = _moved(before, trainer)
    log(f"[coop] Adapter-CoOp {backbone}: {classes} classes, "
        f"{len(dm.dataset.train_x)} train / {len(dm.dataset.test)} test images, "
        f"n_ctx {c.adapter.n_ctx}, {steps} steps in {seconds:.2f} s; "
        f"{_metrics_line(metrics)}; parameters moved by up to {moved}")
    layers = arch.transformer_layers
    _check_launches("coop", launches, {
        "fused_ln_attention_block": 2 * layers * steps, "fused_ln_mlp": 2 * layers * steps,
        "ln_attn_bwd": layers * steps, "ln_mlp_bwd": layers * steps,
    })
    if not moved["ctx"] > 0:
        raise RuntimeError("coop: the context did not move")
    return launches


def phase_cocoop(backbone="ViT-B/16", classes=100):
    """Adapter-CoCoOp: each step runs its images' K prompts through the text
    tower in chunks of PROMPT_BUDGET // K images, each chunk a checkpoint
    segment: K1/K2 forward, again in the backward's recompute, then K4/K3,
    in each of the 12 blocks."""
    from clip_gp_tpu_torch.methods import cocoop

    c, arch = _config(backbone, "Adapter-CoCoOp", shots=1, epochs=1)
    dm = InMemoryDataManager(c, images_per_class=2, num_classes=classes)
    before = {}
    launches, metrics, seconds, trainer = _train(
        c, dm, on_build=lambda t: before.update(_snapshot(t)))
    chunk = max(1, cocoop.PROMPT_BUDGET // classes)
    chunks = c.adapter.clip_adapter_epochs * sum(
        math.ceil(len(batch["label"]) / chunk) for batch in dm.train_loader_x)
    moved = _moved(before, trainer)
    log(f"[cocoop] Adapter-CoCoOp {backbone}: {classes} classes, "
        f"{len(dm.dataset.train_x)} train / {len(dm.dataset.test)} test images, "
        f"{chunks} chunks of {chunk} images x {classes} prompts in "
        f"{seconds:.2f} s; {_metrics_line(metrics)}; parameters moved by up to "
        f"{moved}")
    layers = arch.transformer_layers
    _check_launches("cocoop", launches, {
        "fused_ln_attention_block": 2 * layers * chunks,
        "fused_ln_mlp": 2 * layers * chunks,
        "ln_attn_bwd": layers * chunks, "ln_mlp_bwd": layers * chunks,
    })
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"cocoop: a parameter did not move: {moved}")
    return launches


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

def _cli_argv(root, out, backbone, extra=()):
    """``clip_gp_tpu_torch.train`` flags of the serving phase's run: the
    Adapter (template logits) on the Synthetic dataset at the backbone's
    resolution, no augmentation, checkpoints on."""
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    res = ARCHITECTURES[backbone].image_resolution
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "4",
        "--backbone", backbone, "--seed", "1", "--output-dir", str(out),
        "--batch-size", "32", "--num-templates", "16", *extra,
        "INPUT.SIZE", f"({res}, {res})", "INPUT.TRANSFORMS", "['normalize']",
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "1", "DATALOADER.NUM_WORKERS", "4",
        "TRAIN.PRINT_FREQ", "100", "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
    ]


def _write_pngs(folder, n, size, seed=5):
    """``n`` synthetic images of ``size``x``size`` as PNG files."""
    from PIL import Image

    from clip_gp_tpu_torch.data.datasets.synthetic import synthetic_images

    os.makedirs(folder, exist_ok=True)
    for c, i, img in synthetic_images(4, n // 4, size, seed):
        Image.fromarray(img).save(os.path.join(folder, f"img_{c}_{i:03d}.png"))


def _encode_rates(model, arch, images_u8, preprocess):
    """(fp32 images/s, int8 images/s, top-1 agreement of the two features
    under a fixed random head) on one batch, each the median of 5 timed
    calls after one warm-up."""
    import torch

    from clip_gp_tpu_torch.models import quantized

    qvisual = quantized.quantize_visual(model, arch)
    x = preprocess(images_u8)
    fns = {"fp32": lambda: model.encode_image(x),
           "int8": lambda: quantized.encode_image_q8(qvisual, arch, x)}
    rates, feats = {}, {}
    with torch.no_grad():
        for name, fn in fns.items():
            feats[name] = fn()
            rates[name] = x.shape[0] / (time_ms(fn, iters=5, warmup=1) / 1e3)
    head = torch.randn(arch.embed_dim, 10, generator=torch.Generator().manual_seed(3))
    head = head.to(x.device)
    top = {k: (v / v.norm(dim=-1, keepdim=True) @ head).argmax(-1) for k, v in feats.items()}
    return rates["fp32"], rates["int8"], (top["fp32"] == top["int8"]).float().mean().item()


def phase_serving(device, backbone="ViT-B/16", n_pngs=64):
    """Train a run with the CLI, then serve it with --eval-only and the
    predict entry on the int8 tower; returns the launches of each."""
    import numpy as np
    import torch

    from clip_gp_tpu_torch import predict
    from clip_gp_tpu_torch import train as cli
    from clip_gp_tpu_torch.core.logging import reset_tee
    from clip_gp_tpu_torch.data.datasets.synthetic import synthetic_images
    from clip_gp_tpu_torch.data.transforms import device_preprocess
    from clip_gp_tpu_torch.methods import common
    from clip_gp_tpu_torch.models.clip_loader import init_clip_params
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    arch = ARCHITECTURES[backbone]
    res = arch.image_resolution
    # the text side: every class × template prompt through the text tower
    # once per trainer build, in batches of 256
    text_launches = arch.transformer_layers * math.ceil(4 * 16 / 256)
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        start = time.perf_counter()
        try:
            cli.main(_cli_argv(os.path.join(tmp, "data"), run, backbone))
        finally:
            reset_tee()
        train_s = time.perf_counter() - start

        evald = os.path.join(tmp, "eval")
        _reset_counts()
        start = time.perf_counter()
        try:
            cli.main(_cli_argv(os.path.join(tmp, "data"), evald, backbone, extra=[
                "--eval-only", "--model-dir", run]) + ["MODEL.INT8_INFERENCE", "True"])
        finally:
            reset_tee()
        by_path["eval_only_int8"] = _counts()
        eval_s = time.perf_counter() - start
        with open(os.path.join(evald, "metrics.json")) as f:
            payload = json.load(f)
        metrics = payload["metrics"]
        for key in ("top1_acc", "macro_f1", "ece", "aece"):
            if not np.isfinite(metrics[key]):
                raise RuntimeError(f"--eval-only metrics.json: {key} = {metrics[key]}")
        log(f"[serving] trained {backbone} Adapter (1 epoch) in {train_s:.2f} s; "
            f"--eval-only int8 in {eval_s:.2f} s: {_metrics_line(metrics)}")

        pngs = os.path.join(tmp, "pngs")
        _write_pngs(pngs, n_pngs, res)
        preds = {}
        for name, flags in (("int8", ["--int8"]), ("fp32", [])):
            _reset_counts()
            start = time.perf_counter()
            preds[name] = predict.main([
                "--model-dir", run, "--images", pngs, "--topk", "3",
                "--output", os.path.join(tmp, f"pred-{name}.json"), *flags])
            seconds = time.perf_counter() - start
            by_path[f"predict_{name}"] = _counts()
            log(f"[serving] predict {name}: {preds[name]['num_images']} PNGs in "
                f"{seconds:.2f} s; launches {by_path[f'predict_{name}']}")
        if preds["int8"]["num_images"] != n_pngs or len(preds["int8"]["predictions"]) != n_pngs:
            raise RuntimeError(f"predictions.json: {preds['int8']['num_images']} of "
                               f"{n_pngs} images")
        agree = np.mean([a["topk"][0]["label"] == b["topk"][0]["label"] for a, b in
                         zip(preds["int8"]["predictions"], preds["fp32"]["predictions"])])

        # every ViT block of every int8 image encode: K5 and K6; the image
        # encodes launch no K1/K2 (those come from the text side only). The
        # Synthetic test split (24 of 80 images) is one extraction batch.
        batch = common.extract_device_batch()
        encodes = {"eval_only_int8": math.ceil(24 / batch),
                   "predict_int8": math.ceil(n_pngs / batch)}
        for path, n_encodes in encodes.items():
            launches = by_path[path]
            need = arch.vision_layers * n_encodes
            _check_launches(f"serving {path}", launches,
                            {"q8_ln_attention_block": need, "q8_ln_mlp": need})
            for kernel in ("fused_ln_attention_block", "fused_ln_mlp"):
                if launches[kernel] != text_launches:
                    raise RuntimeError(
                        f"serving {path}: {kernel} launched {launches[kernel]} "
                        f"times, the text side alone launches {text_launches}: "
                        "an int8 image encode went through K1/K2")

    # the run's random weights (seed 1) and the PNGs' pixels, on the card
    model = init_clip_params(arch, seed=1, device=device)
    images = torch.from_numpy(np.stack(
        [img for _, _, img in synthetic_images(4, n_pngs // 4, res, 5)])).to(device)
    fp32_rate, int8_rate, top1 = _encode_rates(model, arch, images, device_preprocess)
    log(f"[serving] {backbone} encode of {n_pngs} images: fp32 {fp32_rate:.1f} "
        f"images/s, int8 {int8_rate:.1f} images/s; top-1 agreement of the "
        f"predict entry's int8 and fp32 runs {100 * agree:.1f}%, of the two "
        f"encodes under a random head {100 * top1:.1f}%")
    return by_path


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

def _lineage_c(p, heads, attention):
    """``x + MHA(LN(x))`` as LN rounded to the working type, ``F.linear``
    qkv, ``attention`` on contiguous [B, H, N, Dh] heads, ``F.linear``
    out-projection and the residual."""
    import torch.nn.functional as F

    from clip_gp_tpu_torch.ops import flash_attention as fa

    x = p["x"]
    b, n, d = x.shape
    h = fa.layer_norm_f32(x, p["ln_scale"], p["ln_bias"]).to(x.dtype)
    qkv = F.linear(h, p["w_qkv_t"], p["b_qkv"])
    q, k, v = (t.reshape(b, n, heads, -1).transpose(1, 2).contiguous()
               for t in qkv.split(d, -1))
    attn = attention(q, k, v).transpose(1, 2).reshape(b, n, d)
    return x + F.linear(attn, p["w_out_t"], p["b_out"])


def _lineage_b(p, heads, block):
    """``x + MHA(LN(x))`` as LN rounded to the working type, ``block`` (K8
    or its plain version) and the residual."""
    from clip_gp_tpu_torch.ops import flash_attention as fa

    x = p["x"]
    h = fa.layer_norm_f32(x, p["ln_scale"], p["ln_bias"]).to(x.dtype)
    return block(h, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"], heads) + x


def phase_blocks(device, n=197, d=768, heads=12, batch=32, lineage_batch=512):
    """K7 and K8 through their public API at ViT-B/16 width: a loss through
    K8's autograd Function, then the lineage comparison. Returns the
    launches of this path."""
    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    names = ("x", "w_qkv", "b_qkv", "w_out", "b_out")
    p = _block_inputs(batch, n, d, False, torch.float32, device, seed=600)
    lineage = {}  # dtype name -> (inputs, the three variants)
    for dtype_name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q = _block_inputs(lineage_batch, n, d, False, dtype, device, seed=601)
        for key in ("w_qkv", "w_out"):
            q[key + "_t"] = q[key].t().contiguous()
        lineage[dtype_name] = (q, {
            "a": lambda q=q: fa.fused_ln_attention_block(
                q["x"], q["ln_scale"], q["ln_bias"], q["w_qkv"], q["b_qkv"],
                q["w_out"], q["b_out"], heads),
            "b": lambda q=q: _lineage_b(q, heads, fa.fused_attention_block),
            "c": lambda q=q: _lineage_c(q, heads, fa.flash_attention),
        })

    def loss(block, leaves):
        return (block(*leaves, heads).float() ** 2).mean()

    _reset_counts()
    leaves = [p[k].detach().clone().requires_grad_(True) for k in names]
    value = loss(fa.fused_attention_block, leaves)
    got = torch.autograd.grad(value, leaves)
    with torch.no_grad():
        outs = {dtype_name: {key: run() for key, run in runs.items()}
                for dtype_name, (_, runs) in lineage.items()}
    torch.cuda.synchronize()
    launches = _counts()

    ref_leaves = [p[k].detach().clone().requires_grad_(True) for k in names]
    ref_value = loss(fa.attention_block_plain, ref_leaves)
    ref = torch.autograd.grad(ref_value, ref_leaves)
    max_abs, max_rel, ok = _compare_grads(got, ref)
    log(f"[blocks] fused_attention_block ViT-B/16 B={batch} fp32: loss "
        f"{value.item():.6f} (plain {ref_value.item():.6f}); gradients of "
        f"{names} vs autograd of the plain version max_abs_err {max_abs:.3e} "
        f"max_rel_err {max_rel:.3e} (tol {BWD_RTOL['fp32']} x (max|plain| + "
        f"|plain|))")
    if not ok or abs(value.item() - ref_value.item()) > 1e-4 * abs(ref_value.item()):
        raise RuntimeError("blocks: K8's Function disagrees with autograd of "
                           "the plain version")
    del leaves, ref_leaves, got, ref

    plain = {"b": lambda q: _lineage_b(q, heads, fa.attention_block_plain),
             "c": lambda q: _lineage_c(q, heads, fa.attention_plain)}
    for dtype_name, (q, runs) in lineage.items():
        atol, rtol = LINEAGE_TOL[dtype_name]
        got = outs.pop(dtype_name)
        with torch.no_grad():
            for key, fn in plain.items():
                max_abs, max_rel, ok = compare(got[key], fn(q), atol, rtol)
                log(f"[blocks] lineage ({key}) ViT-B/16 B={lineage_batch} "
                    f"{dtype_name}: vs the plain composition max_abs_err "
                    f"{max_abs:.3e} max_rel_err {max_rel:.3e} (tol atol "
                    f"{atol:.3e} rtol {rtol:.3e})")
                if not ok or not bool(torch.isfinite(got[key]).all()):
                    raise RuntimeError(f"blocks: lineage ({key}) {dtype_name} "
                                       "disagrees with its plain composition")
            del got
            times = {key: time_ms(run) for key, run in runs.items()}
        log(f"[blocks] lineage ViT-B/16 B={lineage_batch} {dtype_name}, "
            f"x + MHA(LN(x)) in ms: (a) K1 {times['a']:.4f}; (b) LN, K8, + x "
            f"{times['b']:.4f}; (c) LN, F.linear, K7, F.linear, + x "
            f"{times['c']:.4f}")
    del lineage
    torch.cuda.empty_cache()
    _check_launches("blocks", launches, {
        "fused_attention_block": 3, "flash_attention": 2,
        "fused_ln_attention_block": 2})
    return launches


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

# RN50 fp32 encode rates at 32 images and at the trainers' device batch
# (methods/common.py extract_device_batch())
RN50_RATE_BATCHES = (32, 512)


def rn50_state_dict(seed=0):
    """(arch, a random RN50 state dict in the OpenAI layout, ref:
    clip/model.py): vision width 64, layers (3, 4, 6, 3), 224 px, embed 1024,
    the text tower 512 wide with 8 heads and 12 layers. Weights are
    N(0, fan_in^-1/2); every BatchNorm has a random weight, bias, running
    mean and running variance, so that the folding is exercised."""
    import torch

    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    arch = ARCHITECTURES["RN50"]
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(key, *shape, std=None):
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
        sd[key] = torch.randn(shape, generator=g) * (std or fan_in**-0.5)

    def affine(key, n, mean=1.0):  # a LayerNorm's or BatchNorm's weight and bias
        sd[f"{key}.weight"] = mean + 0.1 * torch.randn(n, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(n, generator=g)

    def conv_bn(conv, bn, cout, cin, k):
        normal(f"{conv}.weight", cout, cin, k, k)
        affine(bn, cout)
        sd[f"{bn}.running_mean"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{bn}.running_var"] = 0.5 + torch.rand(cout, generator=g)
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)

    def linear(key, cout, cin):
        normal(f"{key}.weight", cout, cin)
        normal(f"{key}.bias", cout, std=0.02)

    w = arch.vision_width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        conv_bn(f"visual.conv{i}", f"visual.bn{i}", cout, cin, 3)
    cin = w
    for li, n_blocks in enumerate(arch.vision_layers):
        planes = w * 2**li
        for bi in range(n_blocks):
            p = f"visual.layer{li + 1}.{bi}"
            conv_bn(f"{p}.conv1", f"{p}.bn1", planes, cin, 1)
            conv_bn(f"{p}.conv2", f"{p}.bn2", planes, planes, 3)
            conv_bn(f"{p}.conv3", f"{p}.bn3", planes * 4, planes, 1)
            if (li > 0 and bi == 0) or cin != planes * 4:
                conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", planes * 4, cin, 1)
            cin = planes * 4
    embed = w * 32
    normal("visual.attnpool.positional_embedding", (arch.image_resolution // 32) ** 2 + 1,
           embed)
    for name, cout in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                       ("c_proj", arch.embed_dim)):
        linear(f"visual.attnpool.{name}", cout, embed)
    tw = arch.transformer_width
    normal("token_embedding.weight", arch.vocab_size, tw, std=0.02)
    normal("positional_embedding", arch.context_length, tw, std=0.01)
    for i in range(arch.transformer_layers):
        p = f"transformer.resblocks.{i}"
        affine(f"{p}.ln_1", tw)
        normal(f"{p}.attn.in_proj_weight", 3 * tw, tw)
        normal(f"{p}.attn.in_proj_bias", 3 * tw, std=0.02)
        linear(f"{p}.attn.out_proj", tw, tw)
        affine(f"{p}.ln_2", tw)
        linear(f"{p}.mlp.c_fc", 4 * tw, tw)
        linear(f"{p}.mlp.c_proj", tw, 4 * tw)
    affine("ln_final", tw)
    normal("text_projection", tw, arch.embed_dim)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    sd["input_resolution"] = torch.tensor(arch.image_resolution)
    sd["context_length"] = torch.tensor(arch.context_length)
    sd["vocab_size"] = torch.tensor(arch.vocab_size)
    return arch, sd


def phase_rn50_tower(device, smi, pt, n_images=8):
    """The RN50 tower from an OpenAI ``.pt`` through ``load_clip_resolved``
    (``MODEL.INIT_WEIGHTS``), on the card against the same model on the CPU,
    then its fp32 encode rates; returns the launches of its image encodes
    (none: the ResNet tower has no kernel of its own)."""
    import copy

    import torch

    from clip_gp_tpu_torch.models.clip_loader import load_clip_resolved

    c, arch = _config("RN50", "Adapter", shots=1, epochs=1)
    c.model.init_weights = pt
    start = time.perf_counter()
    t_arch, model, _ = load_clip_resolved(c)
    load_s = time.perf_counter() - start
    if (model.text_projection.device.type != device.type
            or t_arch.vision_layers != arch.vision_layers):
        raise RuntimeError(f"RN50 .pt: loaded {t_arch} on {model.text_projection.device}")
    g = torch.Generator().manual_seed(4)
    res = arch.image_resolution
    images = torch.randn(n_images, res, res, 3, generator=g)
    _reset_counts()
    with torch.no_grad():
        got = model.encode_image(images.to(device))
        torch.cuda.synchronize()
        launches = _counts()
        ref = copy.deepcopy(model).to("cpu").encode_image(images)
    got = got.cpu()
    if tuple(got.shape) != (n_images, arch.embed_dim) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"RN50 encode_image: bad output {tuple(got.shape)}")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"[rn50] .pt ({os.path.getsize(pt) / 2**20:.1f} MiB, OpenAI layout, BatchNorm "
        f"folded) loaded in {load_s:.2f} s; encode_image {tuple(got.shape)} fp32: card "
        f"vs CPU max_abs_err {err:.3e} (max |feature| {scale:.3f}; tol "
        f"{TOWER_TOL:.1e} x max |feature|); launches {launches}")
    if err > TOWER_TOL * scale:
        raise RuntimeError("RN50 encode_image: the card disagrees with the CPU")
    if any(launches.values()):
        raise RuntimeError(f"RN50 encode_image launched kernels: {launches}")
    for b in RN50_RATE_BATCHES:
        x = torch.randn(b, res, res, 3, generator=g).to(device)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = time_ms(lambda: model.encode_image(x), iters=5, warmup=2)
        log(f"[rn50] RN50 encode_image fp32 B={b}: {ms:.3f} ms, {b / (ms / 1e3):.1f} "
            f"images/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
        del x
    del model
    torch.cuda.empty_cache()
    return launches


def _rn50_run(pt, name, trainer_name, epochs=3, images_per_class=20, **adapter):
    """One trainer on RN50 loaded from ``pt`` over 4 synthetic classes, 4
    shots, 16 templates; every class x template prompt goes through the text
    tower once (K1 then K2 in each of its 12 blocks), and no RN image encode
    launches either."""
    c, arch = _config("RN50", trainer_name, shots=4, epochs=epochs)
    c.model.init_weights = pt
    c.adapter.num_templates = 16
    for key, value in adapter.items():
        setattr(c.adapter, key, value)
    dm = InMemoryDataManager(c, images_per_class=images_per_class)
    launches, metrics, seconds, _ = _train(c, dm)
    text = arch.transformer_layers * math.ceil(4 * c.adapter.num_templates / 256)
    log(f"[rn50] {name} RN50: {len(dm.dataset.train_x)} train / {len(dm.dataset.test)} "
        f"test images, {epochs} epochs in {seconds:.2f} s; {_metrics_line(metrics)}; "
        f"launches {launches}")
    for kernel in ("fused_ln_attention_block", "fused_ln_mlp"):
        if launches[kernel] != text:
            raise RuntimeError(
                f"{name} RN50: {kernel} launched {launches[kernel]} times; the text "
                f"tower's {text} blocks launch it once each and no RN image encode "
                "launches it")
    return launches


def phase_rn50_trainers(pt):
    """BASELINE #1/#2 (the Adapter with the GP) and #3's heads on RN50."""
    return {
        "rn50_adapter_gp": _rn50_run(pt, "Adapter+GP", "Adapter", use_gp=True),
        "rn50_clip_adapter_gp": _rn50_run(pt, "CLIP-Adapter+GP", "CLIP-Adapter",
                                          use_gp=True),
        "rn50_taskres": _rn50_run(pt, "TaskRes", "TaskRes"),
        "rn50_tip_adapter_f": _rn50_run(pt, "Tip-Adapter-F", "Tip-Adapter",
                                        tip_adapter_trainable=True,
                                        tip_adapter_epochs=3),
    }


def phase_vit_clip_adapter(backbone="ViT-B/16"):
    """One CLIP-Adapter epoch on ViT-B/16: every step re-encodes its images
    through the frozen tower, K1 then K2 in each of the 12 blocks."""
    from clip_gp_tpu_torch.methods import common

    c, arch = _config(backbone, "CLIP-Adapter", shots=16, epochs=1)
    c.adapter.num_templates = 16
    dm = InMemoryDataManager(c, images_per_class=24)
    launches, metrics, seconds, _ = _train(c, dm)
    steps = len(dm.train_loader_x)
    image_encodes = math.ceil(len(dm.dataset.test) / common.extract_device_batch()) + steps
    text_encodes = math.ceil(4 * c.adapter.num_templates / 256)
    log(f"[vit clip-adapter] CLIP-Adapter {backbone}: {len(dm.dataset.train_x)} train / "
        f"{len(dm.dataset.test)} test images, {steps} steps in {seconds:.2f} s; "
        f"{_metrics_line(metrics)}")
    need = (arch.vision_layers * image_encodes
            + arch.transformer_layers * text_encodes)
    _check_launches("vit clip-adapter", launches, {"fused_ln_attention_block": need,
                                                   "fused_ln_mlp": need})
    return launches


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

# phase 10 (b), one Muon step on the card against the same step on the CPU:
# the JAX suite's tolerances and step (tests/test_reference_executed_muon.py)
MUON_TOL = {"2d": 8e-3, "rest": 1e-6}
MUON_STEP = {"lr": 0.02, "weight_decay": 0.01}
# phase 10 (f): the ImageNet-layout tree's classes, and ImageNet-A's subset
OOD_CLASSES, OOD_SUBSET = 1000, 3


def _single_trial_argv(root, out, backbone, extra=(), opts=()):
    """``clip_gp_tpu_torch.train`` flags of phase 10's run: the Adapter with
    the GP on the Synthetic dataset (4 classes, 4 shots) at the backbone's
    resolution, 16 templates, 3 epochs of Muon, TensorBoard and checkpoints
    on."""
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    res = ARCHITECTURES[backbone].image_resolution
    return [
        "--dataset", "Synthetic", "--root", str(root), "--shots", "4",
        "--backbone", backbone, "--seed", "1", "--output-dir", str(out),
        "--batch-size", "32", "--num-templates", "16", "--use-gp",
        "--optimizer", "muon", *extra,
        "INPUT.SIZE", f"({res}, {res})", "INPUT.TRANSFORMS", "['normalize']",
        "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "3", "DATALOADER.NUM_WORKERS", "4",
        "TRAIN.PRINT_FREQ", "100", "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True",
        "TRAIN.ENABLE_TENSORBOARD", "True", *opts,
    ]


def _entry_run(main, argv):
    """An entry point's ``main(argv)`` with the launch counts and the phase
    report set to 0 just before and read just after: (launches, phases,
    trainers built, seconds)."""
    from clip_gp_tpu_torch.core import registry
    from clip_gp_tpu_torch.core.logging import reset_tee
    from clip_gp_tpu_torch.runtime import profiling

    built = []
    build = registry.build_trainer

    def record(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    profiling.reset_phases()
    _reset_counts()
    start = time.perf_counter()
    with mock.patch.object(registry, "build_trainer", record):
        try:
            main(argv)
        finally:
            reset_tee()
    seconds = time.perf_counter() - start
    return _counts(), profiling.phase_report(), built, seconds


def _run_metrics(out):
    import numpy as np

    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)["metrics"]
    for key in ("top1_acc", "macro_f1", "ece", "aece"):
        if not np.isfinite(metrics[key]):
            raise RuntimeError(f"{out}/metrics.json: {key} = {metrics[key]}")
    return metrics


def _tensorboard_outcome(run):
    events = [f for f in os.listdir(os.path.join(run, "tensorboard"))
              if f.startswith("events.out.tfevents")]
    if events:
        size = sum(os.path.getsize(os.path.join(run, "tensorboard", f)) for f in events)
        return f"events written: {len(events)} file(s), {size} bytes"
    with open(os.path.join(run, "log.txt")) as f:
        if "tensorboardX unavailable; scalar logging disabled" in f.read():
            return "tensorboardX unavailable; scalar logging disabled"
    raise RuntimeError(f"{run}: no TensorBoard events and no 'unavailable' line")


def _check_exact(what, launches, want):
    for kernel, count in want.items():
        if launches[kernel] != count:
            raise RuntimeError(f"{what}: {kernel} launched {launches[kernel]} times, "
                               f"expected {count}")


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _muon_card_vs_cpu(trainer):
    """(b): one Muon step from the trained Adapter's parameters with the
    gradient of its loss on the training features, on the card (with cuBLAS's
    reduced-precision bf16 reductions on and off) and on the CPU."""
    import torch

    from clip_gp_tpu_torch.runtime.optim import MuonWithAuxAdam

    leaves = dict(_flat_leaves(trainer.params))
    for p in leaves.values():
        p.grad = None
    loss, _ = trainer._loss(trainer._features_train_dev, trainer._labels_train_dev,
                            trainer.keys.next())
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().clone()
             for k, p in leaves.items()}
    matmul = torch.backends.cuda.matmul
    configured = matmul.allow_bf16_reduced_precision_reduction

    def step(device, reduced=configured):
        matmul.allow_bf16_reduced_precision_reduction = reduced
        try:
            ps = {k: p.detach().to(device).clone() for k, p in leaves.items()}
            opt = MuonWithAuxAdam(list(ps.values()), **MUON_STEP)
            for k, p in ps.items():
                p.grad = grads[k].to(device).clone()
            opt.step()
            return {k: p.cpu() for k, p in ps.items()}
        finally:
            matmul.allow_bf16_reduced_precision_reduction = configured

    cpu = step("cpu")
    moved = max((cpu[k] - leaves[k].detach().cpu()).abs().max().item() for k in cpu
                if cpu[k].dim() >= 2)
    errs = {}
    for reduced in (True, False):
        card = step("cuda", reduced)
        errs[reduced] = {
            group: max([(card[k] - cpu[k]).abs().max().item() for k in cpu
                        if (cpu[k].dim() >= 2) == (group == "2d")] or [0.0])
            for group in ("2d", "rest")
        }
    log(f"[single-trial] (b) Muon step card vs CPU on {len(leaves)} Adapter+GP leaves "
        f"(lr {MUON_STEP['lr']}, wd {MUON_STEP['weight_decay']}; 2-D leaves moved by "
        f"up to {moved:.3e}): bf16 reduced-precision reduction on: 2-D "
        f"{errs[True]['2d']:.3e}, rest {errs[True]['rest']:.3e}; off: 2-D "
        f"{errs[False]['2d']:.3e}, rest {errs[False]['rest']:.3e}; configured "
        f"{'on' if configured else 'off'} (limits {MUON_TOL['2d']} / {MUON_TOL['rest']})")
    for group, err in errs[configured].items():
        if not err <= MUON_TOL[group]:
            raise RuntimeError(f"Muon card vs CPU: {group} error {err:.3e} over "
                               f"{MUON_TOL[group]}")


def _reference_checkpoint(trainer, path, epoch):
    """(e): the trained Adapter+GP state as the reference saves it
    (``torch.save`` of state_dict, epoch, optimizer and scheduler, ref:
    utils/trainer.py:347-374), under the module key names the converter
    reads (clip_gp_tpu_torch/runtime/ref_checkpoint.py)."""
    import torch

    p, b = trainer.params, trainer.gp_buffers
    gp = p["gp"]
    g = "gp_weighter."
    vd = g + "variational_strategy._variational_distribution."
    sd = {
        "visual_proj.weight": p["visual_proj"],
        g + "_templates": b["templates"],
        g + "_templates_red": b["templates_red"],
        g + "variational_strategy.inducing_points": torch.cat(
            [b["templates_red"], gp["inducing_token"]], dim=1),
        vd + "variational_mean": gp["variational_mean"],
        vd + "chol_variational_covar": gp["chol_variational_covar"],
        g + "mean_module.cls_bias": gp["cls_bias"],
        g + "mean_module.tmp_bias": gp["tmp_bias"],
        g + "mean_module.f0": b["f0"],
        g + "A.weight": gp["A"],
        g + "covar_module.base_kernel.raw_lengthscale": gp["raw_lengthscale"],
        g + "covar_module.raw_outputscale": gp["raw_outputscale"],
    }
    sd = {k: v.detach().cpu().clone() for k, v in sd.items()}
    dummy = [torch.nn.Parameter(torch.zeros(1))]
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(torch.optim.AdamW(dummy), T_max=3)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": sd, "epoch": epoch, "optimizer": trainer.opt.opt.state_dict(),
                "scheduler": sched.state_dict()}, path)


def _imagenet_tree(root, size=224):
    """(f): an ImageNet-layout tree at ``size`` px: OOD_CLASSES wnids in
    classnames.txt, ImageNet train and val with one image per class,
    ImageNet-V2 (its numeric label folders, one image each) and ImageNet-A
    with the first OOD_SUBSET classes, two images each."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(11)
    jpegs = []
    for _ in range(4):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)).save(
            buf, format="JPEG")
        jpegs.append(buf.getvalue())
    wnids = [f"n{i:08d}" for i in range(OOD_CLASSES)]
    names = "".join(f"{w} class {i}\n" for i, w in enumerate(wnids))

    def write(folder, name, i):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, name), "wb") as f:
            f.write(jpegs[i % len(jpegs)])

    for dataset in ("imagenet", "imagenetv2", "imagenet-adversarial"):
        os.makedirs(os.path.join(root, dataset), exist_ok=True)
        with open(os.path.join(root, dataset, "classnames.txt"), "w") as f:
            f.write(names)
    for i, w in enumerate(wnids):
        for split in ("train", "val"):
            write(os.path.join(root, "imagenet", "images", split, w), "0.JPEG", i)
        write(os.path.join(root, "imagenetv2", "imagenetv2-matched-frequency-format-val",
                           str(i)), "0.jpeg", i + 1)
    for i, w in enumerate(wnids[:OOD_SUBSET]):
        for j in range(2):
            write(os.path.join(root, "imagenet-adversarial", "imagenet-a", w), f"{j}.jpg",
                  i + j + 2)


def _phase_ood(tmp, backbone):
    """(f): train the Adapter for 1 epoch on the ImageNet tree with the CLI,
    then evaluate it on ImageNet-V2 (every class) and ImageNet-A (a subset,
    remapped by wnid) with the OOD entry."""
    from clip_gp_tpu_torch import ood_eval
    from clip_gp_tpu_torch import train as cli
    from clip_gp_tpu_torch.methods import common
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    res = ARCHITECTURES[backbone].image_resolution
    root, run = os.path.join(tmp, "imagenet-tree"), os.path.join(tmp, "ood_run")
    start = time.perf_counter()
    _imagenet_tree(root, res)
    tree_s = time.perf_counter() - start
    launches_train, _, _, train_s = _entry_run(cli.main, [
        "--dataset", "ImageNet", "--root", root, "--shots", "1", "--backbone", backbone,
        "--seed", "1", "--output-dir", run, "--batch-size", "32", "--num-templates", "2",
        "INPUT.SIZE", f"({res}, {res})", "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "1",
        "DATALOADER.NUM_WORKERS", "4", "TRAIN.PRINT_FREQ", "100",
        "TRAIN.ENABLE_ADAPTER_CHECKPOINTS", "True"])
    launches, _, built, ood_s = _entry_run(ood_eval.main, [
        "--model-dir", run, "--root", root, "--variants", "ImageNetV2,ImageNetA"])
    with open(os.path.join(run, "ood_metrics.json")) as f:
        summary = json.load(f)
    want = {"ImageNetV2": (OOD_CLASSES, OOD_CLASSES), "ImageNetA": (OOD_SUBSET, 2 * OOD_SUBSET)}
    for name, (classes, images) in want.items():
        row = summary["variants"][name]
        if "error" in row or (row["num_classes"], row["num_images"]) != (classes, images):
            raise RuntimeError(f"ood_metrics.json {name}: {row}")
        metrics = _run_metrics(os.path.join(run, "ood", name))
        log(f"[single-trial] (f) OOD {name}: {classes} classes, {images} images; "
            f"{_metrics_line(metrics)}")
    if len(built) != 2:
        raise RuntimeError(f"ood_eval built {len(built)} trainers, expected 2")
    log(f"[single-trial] (f) ImageNet tree of {OOD_CLASSES} classes at {res} px written in "
        f"{tree_s:.2f} s; trained 1 epoch in {train_s:.2f} s; OOD entry in {ood_s:.2f} s; "
        f"launches train {launches_train}, OOD {launches}")
    # K1/K2 in every block of each encode: the training run encodes 2
    # templates of every class, its train and its val split; the OOD entry
    # builds one trainer a variant, each encoding 2 templates of its own
    # classes and its test split
    arch = ARCHITECTURES[backbone]
    layers, vision = arch.transformer_layers, arch.vision_layers
    batch = common.extract_device_batch()
    want = {
        "ood_train": (layers * math.ceil(2 * OOD_CLASSES / 256)
                      + 2 * vision * math.ceil(OOD_CLASSES / batch)),
        "ood": (layers * (math.ceil(2 * OOD_CLASSES / 256) + math.ceil(2 * OOD_SUBSET / 256))
                + vision * (math.ceil(OOD_CLASSES / batch) + math.ceil(2 * OOD_SUBSET / batch))),
    }
    for path, got in (("ood_train", launches_train), ("ood", launches)):
        _check_exact(path, got, {"fused_ln_attention_block": want[path],
                                 "fused_ln_mlp": want[path]})
    return {"ood_train": launches_train, "ood": launches}


def phase_single_trial(backbone="ViT-B/16"):
    """Phase 10: the single-trial surfaces of ``train.py`` on ViT-B/16 full
    width: (a) the Adapter + GP with Muon, TensorBoard, the feature cache and
    the trace; (b) a Muon step on the card against the CPU; (c) the same run
    again, its test split from the cache; (d) FINETUNE_ON_TEST; (e) the
    trained state served from a reference-format checkpoint against its npz;
    (f) the OOD entry. Returns the launches of each run."""
    import numpy as np

    from clip_gp_tpu_torch import train as cli
    from clip_gp_tpu_torch.methods import common
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES
    from clip_gp_tpu_torch.runtime import feature_cache

    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    arch = ARCHITECTURES[backbone]
    batch = common.extract_device_batch()
    # the Synthetic dataset: 4 classes, 16 training images at 4 shots, 24 test
    text = arch.transformer_layers * math.ceil(4 * 16 / 256)
    train_enc = arch.vision_layers * math.ceil(16 / batch)
    test_enc = arch.vision_layers * math.ceil(24 / batch)
    kernels = ("fused_ln_attention_block", "fused_ln_mlp")
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        data, cache, prof = (os.path.join(tmp, d) for d in ("data", "cache", "prof"))
        with mock.patch.dict(os.environ, {"CLIP_GP_TPU_TORCH_FEATURE_CACHE": cache}):
            # (a) the first run, traced
            feature_cache.memo_clear()
            run_a = os.path.join(tmp, "run_a")
            with mock.patch.dict(os.environ, {"CLIP_GP_TPU_TORCH_PROFILE_DIR": prof}):
                launches, phases_a, built, seconds = _entry_run(
                    cli.main, _single_trial_argv(data, run_a, backbone))
            trainer = built[0]
            by_path["single_trial"] = launches
            metrics_a = _run_metrics(run_a)
            files = sorted(os.listdir(cache))
            traces = [os.path.join(d, f) for d, _, fs in os.walk(prof) for f in fs]
            log(f"[single-trial] (a) Adapter+GP {backbone}, Muon, 3 epochs in "
                f"{seconds:.2f} s; {_metrics_line(metrics_a)}")
            log(f"[single-trial] (a) phases {json.dumps(phases_a)}")
            log(f"[single-trial] (a) feature cache files written: {files}")
            log(f"[single-trial] (a) tensorboard {_tensorboard_outcome(run_a)}")
            device_events = 0
            for t in traces:
                with open(t) as f:
                    device_events += sum(e.get("cat") == "kernel"
                                         for e in json.load(f)["traceEvents"])
            log(f"[single-trial] (a) trace: {len(traces)} file(s), "
                f"{sum(os.path.getsize(t) for t in traces)} bytes under {prof}, "
                f"{device_events} device kernel events")
            log(f"[single-trial] (a) launches K1 {launches[kernels[0]]}, K2 "
                f"{launches[kernels[1]]} (text {text}, train {train_enc}, test {test_enc})")
            tag = f"_torch-{trainer.device.type}.npz"
            if len(files) != 1 or not files[0].endswith(tag):
                raise RuntimeError(f"feature cache: expected one *{tag} file, {files}")
            if not traces or not all(os.path.getsize(t) for t in traces):
                raise RuntimeError(f"no torch.profiler trace under {prof}")
            if (phases_a.get("feature_extraction", {}).get("count") != 2
                    or phases_a.get("train_epochs", {}).get("count") != 1):
                raise RuntimeError(f"phase report: {phases_a}")
            _check_exact("single-trial (a)", launches,
                         {k: text + train_enc + test_enc for k in kernels})

            # (b) Muon on the card against the CPU
            _muon_card_vs_cpu(trainer)

            # (c) the same config again, from a fresh memo: the test split
            # loads from the disk cache and launches nothing on the image side
            feature_cache.memo_clear()
            run_c = os.path.join(tmp, "run_c")
            launches_c, phases_c, built_c, seconds_c = _entry_run(
                cli.main, _single_trial_argv(data, run_c, backbone))
            by_path["cached"] = launches_c
            with open(os.path.join(run_c, "log.txt")) as f:
                hits = [line.strip() for line in f if "[feature-cache] hit" in line]
            with np.load(os.path.join(cache, files[0])) as stored:
                stored_feats = stored["features"]
            equal = (np.array_equal(built_c[0].features_test, stored_feats)
                     and np.array_equal(built_c[0].features_test, trainer.features_test))
            log(f"[single-trial] (c) second run in {seconds_c:.2f} s: {len(hits)} cache "
                f"hit(s) ({hits[0] if hits else ''}); image-tower K1 on the cached split "
                f"{launches[kernels[0]] - text - train_enc} in (a), "
                f"{launches_c[kernels[0]] - text - train_enc} in (c); features "
                f"equal bit for bit: {equal}; feature_extraction "
                f"{phases_a['feature_extraction']['total_s']:.3f} s "
                f"({phases_a['feature_extraction']['count']} extractions) in (a), "
                f"{phases_c['feature_extraction']['total_s']:.3f} s "
                f"({phases_c['feature_extraction']['count']}) in (c)")
            if len(hits) != 1 or not equal:
                raise RuntimeError("the second run did not load the cached test split")
            _check_exact("single-trial (c)", launches_c, {k: text + train_enc for k in kernels})

            # (d) FINETUNE_ON_TEST on the run's (cached) test features
            run_d = os.path.join(tmp, "run_d")
            launches_d, _, _, seconds_d = _entry_run(cli.main, _single_trial_argv(
                data, run_d, backbone, opts=["TRAINER.ADAPTER.FINETUNE_ON_TEST", "True"]))
            by_path["finetune_on_test"] = launches_d
            with open(os.path.join(run_d, "log.txt")) as f:
                sanity = [line.strip() for line in f if line.startswith("[SANITY]")]
            epochs = [line for line in sanity if "fine-tune epoch" in line]
            log(f"[single-trial] (d) FINETUNE_ON_TEST in {seconds_d:.2f} s: {len(epochs)} "
                f"epochs; {sanity[0] if sanity else ''} | {epochs[-1] if epochs else ''}")
            if len(epochs) != 100 or "epoch 100/100" not in epochs[-1]:
                raise RuntimeError(f"FINETUNE_ON_TEST: {len(epochs)} epoch lines")
            _run_metrics(run_d)

            # (e) the state of (a) served from its npz and from a
            # reference-format checkpoint
            ref = os.path.join(tmp, "ref")
            _reference_checkpoint(trainer, os.path.join(ref, "adapter", "model.pth.tar-3"), 3)
            served = {}
            for name, model_dir in (("eval_npz", run_a), ("ref_ckpt", ref)):
                out = os.path.join(tmp, name)
                by_path[name], _, _, secs = _entry_run(cli.main, _single_trial_argv(
                    data, out, backbone, extra=["--eval-only", "--model-dir", model_dir]))
                served[name] = _run_metrics(out)
                with open(os.path.join(out, "log.txt")) as f:
                    loaded = [line.strip() for line in f if "checkpoint from" in line]
                log(f"[single-trial] (e) {name} in {secs:.2f} s ({loaded}): "
                    f"{_metrics_line(served[name])}")
            diff = {k: abs(served["ref_ckpt"][k] - served["eval_npz"][k])
                    for k in ("top1_acc", "macro_f1", "ece", "aece")}
            log(f"[single-trial] (e) reference checkpoint vs npz: |diff| {diff}")
            if diff["top1_acc"] != 0 or max(diff.values()) > 1e-3:
                raise RuntimeError(f"reference-checkpoint serving differs from the npz: {diff}")

        # (f) OOD
        by_path.update(_phase_ood(tmp, backbone))
    return by_path


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

# phase 11's groups: the seeds (T = 4 per group, 8 with the lr grid), the GP
# trainer's OPTIM.LR grid, the classes of the CoOp tree and its shots
SWEEP_SEEDS = [1, 2, 3, 4]
SWEEP_LRS = [1e-3, 1e-2]
SWEEP_COOP_CLASSES = 100
# CoOp's images per step: all of the 1-shot tree's 100 in one batch, so the
# in-process trial's loader shuffle and the group's per-trial permutation
# give each step the same images and the two runs can be compared
SWEEP_COOP_BATCH = 128
# a trial run in-process or in a child process against the same trial of a
# trial-batched group: top-1 equal, the other metrics within this
SWEEP_METRIC_TOL = 1e-3
# CoCoOp's group: one epoch of one step over all 100 images (50 chunks of
# 2 images, T x C x K = 800 prompts a tower call), a random 16-token
# context per trial (cocoop.yaml's phrase init would give every trial the
# same context and 16-token prompts), the same 24-token prompts as CoOp
SWEEP_COCOOP = dict(TRAINER={"ADAPTER": {"CLIP_ADAPTER_EPOCHS": 1, "N_CTX": 16,
                                         "CTX_INIT": ""}},
                    DATALOADER={"TRAIN_X": {"BATCH_SIZE": SWEEP_COOP_BATCH}})
# the decode-ahead pair: the GP trainer's config at two shot counts (two
# feature-cached groups of T=4 on the 100-class tree), run with and without
# decode-ahead; these metrics.json fields are wall clock, all others must
# be equal
SWEEP_PREFETCH_SHOTS = [1, 2]
WALL_CLOCK_FIELDS = ("timestamp", "train_time_s")


def _deep_update(base, over):
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _deep_update(base[key], value)
        else:
            base[key] = value
    return base


def _experiment_yaml(path, trainer_yaml, root, out_root, name, backbone, seeds,
                     shots, grid, **trainer):
    """An experiment YAML on the repo's ``configs/trainers/<trainer_yaml>``
    (its trainer block as it is, over ``default.yaml``), cut to the smoke:
    the Synthetic tree under ``root``, ``backbone`` at its resolution with no
    augmentation, batches of 32, and ``trainer``'s overrides (YAML
    sections)."""
    import yaml

    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "configs", "trainers", trainer_yaml)) as f:
        spec = yaml.safe_load(f)
    res = ARCHITECTURES[backbone].image_resolution
    base = spec.get("BASE_CONFIG")
    if base:
        spec["BASE_CONFIG"] = os.path.join(repo, base)
    _deep_update(spec, {
        "name": name, "root": str(root), "datasets": ["synthetic"],
        "seeds": list(seeds), "shots": list(shots), "grid": grid,
        "output_root": str(out_root),
        "dataset_config": os.path.join(repo, "configs", "datasets", "synthetic.yaml"),
        "MODEL": {"BACKBONE": {"NAME": backbone}},
        "INPUT": {"SIZE": f"({res}, {res})", "TRANSFORMS": ["normalize"]},
        "DATALOADER": {"NUM_WORKERS": 4, "TRAIN_X": {"BATCH_SIZE": 32},
                       "TEST": {"BATCH_SIZE": 32}},
        "TRAIN": {"PRINT_FREQ": 100},
    })
    _deep_update(spec, trainer)
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    return str(path)


class _RunnerProbe:
    """Records what each trial-batched group of a sweep did: its runner, the
    size of every union it encoded (train unions per epoch and the val
    union) and its initial state."""

    def __enter__(self):
        from clip_gp_tpu_torch.parallel import trial_vmap as tv

        probe = self
        self.runners, self.unions, self.initial = [], [], []
        run, encode, init = (tv.VmappedTrials.run, tv.VmappedTrials._encode_union,
                             tv.VmappedTrials._initial_params)

        def run_(runner, *args, **kwargs):
            probe.runners.append(runner)
            return run(runner, *args, **kwargs)

        def encode_(runner, base, items, *args, **kwargs):
            probe.unions.append(len(items))
            return encode(runner, base, items, *args, **kwargs)

        def init_(runner, spec):
            state = init(runner, spec)
            probe.initial.append(tv.tree_map(lambda v: v.detach().clone(), state))
            return state

        self._patches = [mock.patch.object(tv.VmappedTrials, name, fn) for name, fn in
                         (("run", run_), ("_encode_union", encode_),
                          ("_initial_params", init_))]
        for patch in self._patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self._patches:
            patch.stop()


def _sweep_run(yaml_path, *args):
    """``sweep.main`` on one experiment YAML with the launch counts and the
    phase report set to 0 just before and read just after, ended by a CUDA
    synchronize: (results, launches, phases, seconds). Every trial must have
    run and written a finite metrics.json."""
    import numpy as np
    import torch

    from clip_gp_tpu_torch.parallel import sweep
    from clip_gp_tpu_torch.runtime import feature_cache, profiling

    feature_cache.memo_clear()
    profiling.reset_phases()
    _reset_counts()
    start = time.perf_counter()
    results = sweep.main(["--config-file", yaml_path, *args])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _counts()
    for r in results:
        if r["return_code"] != 0:
            raise RuntimeError(f"sweep {yaml_path}: trial {r} failed")
        with open(os.path.join(r["out_dir"], "metrics.json")) as f:
            r["metrics"] = json.load(f)["metrics"]
        for key in ("top1_acc", "ece", "aece"):
            if not np.isfinite(r["metrics"][key]):
                raise RuntimeError(f"{r['out_dir']}/metrics.json: {key} not finite")
    return results, launches, profiling.phase_report(), seconds


def _image_encodes(sizes, batch):
    """Image-tower passes of extractions of ``sizes`` images each."""
    return sum(math.ceil(n / batch) for n in sizes)


def _vmapped(what, results, n_trials):
    if len(results) != n_trials or any(r["backend"] != "vmap" for r in results):
        raise RuntimeError(f"{what}: expected {n_trials} trials on the trial-batched "
                           f"backend, got {[(r['seed'], r['backend']) for r in results]}")


def _check_same_trial(path, got, ref):
    """A trial run alone against the same trial of its trial-batched group:
    top-1 equal, the other metrics within SWEEP_METRIC_TOL. Returns the
    differences."""
    diff = {k: abs(got["metrics"][k] - ref["metrics"][k])
            for k in ("top1_acc", "ece", "aece", "macro_f1")}
    if diff["top1_acc"] != 0 or max(diff.values()) > SWEEP_METRIC_TOL:
        raise RuntimeError(f"{path}: the trial differs from its trial-batched "
                           f"run: {diff}")
    return diff


class _Tee:
    """Writes to the smoke's stdout and keeps a copy, so a check can read
    what a run printed."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self):
        return "".join(self.parts)


def _trial_payloads(results):
    """Each trial's metrics.json without its wall-clock fields, by (shots,
    seed)."""
    out = {}
    for r in results:
        with open(os.path.join(r["out_dir"], "metrics.json")) as f:
            payload = json.load(f)
        for key in WALL_CLOCK_FIELDS:
            payload.pop(key)
        out[(r["shots"], r["seed"])] = payload
    return out


def _sweep_line(path, seconds, n_trials, trial_seconds, phases, launches,
                trial_launches, smi, extra=""):
    k1 = "fused_ln_attention_block"
    log(f"[sweep] {path}: {n_trials} trials in {seconds:.2f} s, "
        f"{seconds / n_trials:.3f} s per trial; the in-process trial "
        f"{trial_seconds:.2f} s; K1 {launches[k1]} launches (T x the in-process "
        f"trial's {trial_launches[k1]} = {n_trials * trial_launches[k1]}){extra}; "
        f"phases {json.dumps(phases)}; {smi}")


def phase_sweep(smi, backbone="ViT-B/16"):
    """Phase 11: the sweep runner through ``parallel.sweep.main`` on the
    trial-batched backend (``--backend vmap --strict-vmap``), each group
    beside one of its trials run in-process: the GP trainer's seeds x lr
    grid (T=8), CoOp and CoCoOp on 100 classes (T=4), Tip-Adapter-F (T=4),
    the Adapter without the GP (T=8) against one trial in-process and in a
    child process, two GP groups without and with decode-ahead, then the
    aggregator over the output tree. Returns the launches of each run in
    this process."""
    import io
    import shutil
    from contextlib import redirect_stdout

    import torch

    from clip_gp_tpu_torch.data.datasets.synthetic import generate_synthetic_imagefolder
    from clip_gp_tpu_torch.methods import common
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES
    from clip_gp_tpu_torch.parallel import trial_vmap
    from clip_gp_tpu_torch.parallel.trial_specs import tree_leaves
    from clip_gp_tpu_torch.reporting import aggregate

    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    arch = ARCHITECTURES[backbone]
    layers_v, layers_t = arch.vision_layers, arch.transformer_layers
    batch = common.extract_device_batch()
    k1, k2, k3, k4 = ("fused_ln_attention_block", "fused_ln_mlp", "ln_attn_bwd",
                      "ln_mlp_bwd")
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        small, wide, out = (os.path.join(tmp, d) for d in ("small", "wide", "out"))
        # the Synthetic dataset's own tree (4 classes), and one of 100
        generate_synthetic_imagefolder(small)
        generate_synthetic_imagefolder(wide, num_classes=SWEEP_COOP_CLASSES,
                                       images_per_class=6)

        def experiment(name, trainer_yaml, root, seeds, shots, grid, **trainer):
            return _experiment_yaml(os.path.join(tmp, f"{name}.yaml"), trainer_yaml,
                                    root, out, name, backbone, seeds, shots, grid,
                                    **trainer)

        def trial(name, trainer_yaml, root, shots, grid, **trainer):
            """The group's first trial alone, in-process: its time and launches."""
            path = experiment(name, trainer_yaml, root, SWEEP_SEEDS[:1], shots,
                              {k: v[:1] for k, v in grid.items()}, **trainer)
            results, launches, _, seconds = _sweep_run(path, "--backend", "inprocess")
            return results[0], launches, seconds

        # (a) the GP trainer's config, seeds x OPTIM.LR: one group of 8
        gp = dict(TRAINER={"ADAPTER": {"CLIP_ADAPTER_EPOCHS": 20}})
        grid = {"OPTIM.LR": SWEEP_LRS}
        with _RunnerProbe() as probe:
            results, launches, phases, seconds = _sweep_run(
                experiment("sweep_adapter_gp", "gp.yaml", small, SWEEP_SEEDS, [4], grid,
                           **gp), "--backend", "vmap", "--strict-vmap")
        _vmapped("sweep_adapter_gp", results, 8)
        runner = probe.runners[0]
        want = (layers_v * (_image_encodes(probe.unions, batch)
                            + _image_encodes([len(runner.labels_test)], batch))
                + layers_t * math.ceil(runner.k * runner.m / 256))
        _check_exact("sweep_adapter_gp", launches, {k1: want, k2: want})
        _, trial_launches, trial_s = trial("sweep_adapter_gp_trial", "gp.yaml", small,
                                           [4], grid, **gp)
        _sweep_line("sweep_adapter_gp", seconds, 8, trial_s, phases, launches,
                    trial_launches, smi, extra=f" (text, union of {probe.unions} "
                    f"images and {len(runner.labels_test)} test images once per group)")
        by_path["sweep_adapter_gp"] = launches
        by_path["sweep_adapter_gp_trial"] = trial_launches

        # (b) CoOp on 100 classes, 1 shot, 2 epochs: one group of 4, its
        # seed-1 trial held to the same trial run in-process
        coop = dict(TRAINER={"ADAPTER": {"CLIP_ADAPTER_EPOCHS": 2}},
                    DATALOADER={"TRAIN_X": {"BATCH_SIZE": SWEEP_COOP_BATCH}})
        with _RunnerProbe() as probe:
            results, launches, phases, seconds = _sweep_run(
                experiment("sweep_coop", "coop.yaml", wide, SWEEP_SEEDS, [1], {}, **coop),
                "--backend", "vmap", "--strict-vmap")
        _vmapped("sweep_coop", results, 4)
        runner = probe.runners[0]
        # 1 shot: as many train images as classes
        steps = 2 * len(common.batch_slices(runner.k, SWEEP_COOP_BATCH))
        moved = (runner.params["ctx"] - probe.initial[0]["ctx"]).abs().flatten(1).amax(1)
        images = (_image_encodes(probe.unions, batch)
                  + _image_encodes([len(runner.labels_test)], batch))
        text = math.ceil(runner.k * runner.m / 256) + steps + 1
        _check_exact("sweep_coop", launches, {
            k1: layers_v * images + layers_t * text, k2: layers_v * images + layers_t * text,
            k3: layers_t * steps, k4: layers_t * steps})
        if not bool((moved > 0).all()):
            raise RuntimeError(f"sweep_coop: a trial's context did not move: {moved}")
        one, trial_launches, trial_s = trial("sweep_coop_trial", "coop.yaml", wide, [1],
                                             {}, **coop)
        [ref] = [r for r in results if r["seed"] == SWEEP_SEEDS[0]]
        diff = _check_same_trial("sweep_coop", one, ref)
        _sweep_line("sweep_coop", seconds, 4, trial_s, phases, launches, trial_launches,
                    smi, extra=f"; seed {SWEEP_SEEDS[0]} in-process against its "
                    f"trial-batched run: |diff| {diff}; {steps} steps, K3 {launches[k3]} "
                    f"and K4 {launches[k4]} = {launches[k3] // steps} per step ({layers_t} "
                    f"blocks) at T x K = {4 * runner.k} prompts, the in-process trial's K3 "
                    f"{trial_launches[k3]}; every trial's context moved, by up to "
                    f"{[round(v, 6) for v in moved.tolist()]}")
        by_path["sweep_coop"] = launches
        by_path["sweep_coop_trial"] = trial_launches

        # (b2) CoCoOp on the same 100 classes, 1 shot, under --strict-vmap:
        # one group of 4 whose every image chunk sends T x C x K prompts
        # through one tower call, its seed-1 trial held to the same trial
        # run in-process
        from clip_gp_tpu_torch.methods import cocoop

        with _RunnerProbe() as probe:
            results, launches, phases, seconds = _sweep_run(
                experiment("sweep_cocoop", "cocoop.yaml", wide, SWEEP_SEEDS, [1], {},
                           **SWEEP_COCOOP),
                "--backend", "vmap", "--strict-vmap")
        _vmapped("sweep_cocoop", results, 4)
        runner = probe.runners[0]
        chunk = max(1, cocoop.PROMPT_BUDGET // runner.k)
        slices = common.batch_slices(runner.k, SWEEP_COOP_BATCH)
        train_chunks = sum(math.ceil((hi - lo) / chunk) for lo, hi in slices)
        eval_chunks = math.ceil(len(runner.labels_test) / chunk)
        images = (_image_encodes(probe.unions, batch)
                  + _image_encodes([len(runner.labels_test)], batch))
        text = math.ceil(runner.k * runner.m / 256)
        fwd = layers_v * images + layers_t * (text + 2 * train_chunks + eval_chunks)
        _check_exact("sweep_cocoop", launches, {
            k1: fwd, k2: fwd, k3: layers_t * train_chunks, k4: layers_t * train_chunks})
        moved = {path: (leaf - dict(tree_leaves(probe.initial[0]))[path]).abs()
                 .flatten(1).amax(1).tolist()
                 for path, leaf in tree_leaves(runner.params)}
        if not all(v > 0 for per_trial in moved.values() for v in per_trial):
            raise RuntimeError(f"sweep_cocoop: a trial's parameter did not move: {moved}")
        one, trial_launches, trial_s = trial("sweep_cocoop_trial", "cocoop.yaml", wide,
                                             [1], {}, **SWEEP_COCOOP)
        [ref] = [r for r in results if r["seed"] == SWEEP_SEEDS[0]]
        diff = _check_same_trial("sweep_cocoop", one, ref)
        if diff["macro_f1"] != 0:
            raise RuntimeError(f"sweep_cocoop: macro-F1 differs from the in-process "
                               f"trial: {diff}")
        _sweep_line("sweep_cocoop", seconds, 4, trial_s, phases, launches, trial_launches,
                    smi, extra=f"; seed {SWEEP_SEEDS[0]} in-process against its "
                    f"trial-batched run: |diff| {diff}; {train_chunks} train and "
                    f"{eval_chunks} eval chunks of {chunk} images at T x C x K = "
                    f"{4 * chunk * runner.k} prompts of {runner.spec.prompt_len} tokens, K3 "
                    f"{launches[k3]} and K4 {launches[k4]}, the in-process trial's K3 "
                    f"{trial_launches[k3]}; every trial's ctx and meta-net moved, by "
                    f"up to {json.dumps({k: max(v) for k, v in moved.items()})}")
        by_path["sweep_cocoop"] = launches
        by_path["sweep_cocoop_trial"] = trial_launches

        # (c) Tip-Adapter-F: the val split and each trial's (beta, alpha)
        tip = dict(TRAINER={"ADAPTER": {"TIP_ADAPTER_EPOCHS": 10}})
        with _RunnerProbe() as probe:
            results, launches, phases, seconds = _sweep_run(
                experiment("sweep_tip_f", "tipa_f.yaml", small, SWEEP_SEEDS, [4], {}, **tip),
                "--backend", "vmap", "--strict-vmap")
        _vmapped("sweep_tip_f", results, 4)
        runner = probe.runners[0]
        betas, alphas = runner.consts["beta"].tolist(), runner.consts["alpha"].tolist()
        if not (set(betas) <= {1.0, 2.0, 5.0} and set(alphas) <= {1.0, 5.0, 10.0, 20.0, 50.0}):
            raise RuntimeError(f"sweep_tip_f: (beta, alpha) off the grid: {betas} {alphas}")
        images = (_image_encodes(probe.unions, batch)
                  + _image_encodes([len(runner.labels_test)], batch))
        want = layers_v * images + layers_t * math.ceil(runner.k * runner.m / 256)
        _check_exact("sweep_tip_f", launches, {k1: want, k2: want})
        _, trial_launches, trial_s = trial("sweep_tip_f_trial", "tipa_f.yaml", small, [4],
                                           {}, **tip)
        _sweep_line("sweep_tip_f", seconds, 4, trial_s, phases, launches, trial_launches,
                    smi, extra=f"; val union {probe.unions[1]} images, per-trial "
                    f"(beta, alpha) {list(zip(betas, alphas))}")
        by_path["sweep_tip_f"] = launches
        by_path["sweep_tip_f_trial"] = trial_launches

        # (d) the Adapter without the GP, seeds x OPTIM.LR (T=8), against its
        # trial (seed 1, the first lr) run in-process and in a child process
        results, launches, phases, seconds = _sweep_run(
            experiment("sweep_adapter", "baseline.yaml", small, SWEEP_SEEDS, [4], grid,
                       **gp), "--backend", "vmap", "--strict-vmap")
        _vmapped("sweep_adapter", results, 8)
        sig = f"LR{SWEEP_LRS[0]}"
        [ref] = [r for r in results if r["seed"] == SWEEP_SEEDS[0] and r["sig"] == sig]
        by_path["sweep_adapter"] = launches
        for path, args in (("sweep_inprocess", ("--backend", "inprocess")),
                           ("sweep_subprocess", ("--backend", "subprocess",
                                                 "--devices", "0", "--verbose"))):
            one = experiment(path, "baseline.yaml", small, SWEEP_SEEDS[:1], [4],
                             {"OPTIM.LR": SWEEP_LRS[:1]}, **gp)
            [got], run_launches, _, run_s = _sweep_run(one, *args)
            diff = _check_same_trial(path, got, ref)
            log(f"[sweep] {path}: the trial (seed {SWEEP_SEEDS[0]}, {sig}) in "
                f"{run_s:.2f} s against the same trial of the trial-batched group "
                f"({seconds:.2f} s for 8, {seconds / 8:.3f} s per trial): |diff| {diff}; "
                f"{smi}")
            if path == "sweep_inprocess":
                # a child's launches are counted in the child
                by_path[path] = run_launches

        # (f) decode-ahead: one sweep of two feature-cached groups (the GP
        # trainer's config at two shot counts) without and with it; each
        # trial's metrics.json must be the same but for its wall clock
        pair = experiment("sweep_prefetch", "gp.yaml", wide, SWEEP_SEEDS,
                          SWEEP_PREFETCH_SHOTS, {}, **gp)
        runs = {}
        for mode, disable in (("sequential", "1"), ("decode-ahead", None)):
            shutil.rmtree(os.path.join(out, "sweep_prefetch"), ignore_errors=True)
            if disable:
                os.environ["CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH"] = disable
            made = []
            real = trial_vmap.DecodePrefetcher

            def recording(*args, **kwargs):
                made.append(real(*args, **kwargs))
                return made[-1]

            tee = _Tee(sys.stdout)
            try:
                with mock.patch.object(trial_vmap, "DecodePrefetcher", recording), \
                        redirect_stdout(tee):
                    results, launches, phases, seconds = _sweep_run(
                        pair, "--backend", "vmap", "--strict-vmap")
            finally:
                os.environ.pop("CLIP_GP_TPU_TORCH_DISABLE_DECODE_PREFETCH", None)
            _vmapped(f"sweep_prefetch ({mode})", results, 4 * len(SWEEP_PREFETCH_SHOTS))
            announced = "[vmap] decode-ahead: prefetching group 2/2" in tee.text()
            if announced != (disable is None) or len(made) != (disable is None) or not all(
                    pf.consumed for pf in made):
                raise RuntimeError(f"sweep_prefetch ({mode}): decode-ahead announced "
                                   f"{announced}, {len(made)} prefetchers, consumed "
                                   f"{[pf.consumed for pf in made]}")
            runs[mode] = (_trial_payloads(results), seconds, phases)
            by_path[f"sweep_prefetch_{mode.replace('-', '_')}"] = launches
        (seq, seq_s, seq_phases), (ahead, ahead_s, ahead_phases) = (
            runs["sequential"], runs["decode-ahead"])
        differ = sorted({f"{key}:{field}" for key in seq for field in seq[key]
                         if seq[key][field] != ahead[key].get(field)})
        if set(seq) != set(ahead) or differ:
            raise RuntimeError(f"sweep_prefetch: metrics.json differs with decode-ahead: "
                               f"{differ or (sorted(seq), sorted(ahead))}")
        log(f"[sweep] sweep_prefetch: {len(seq)} trials in 2 groups (shots "
            f"{SWEEP_PREFETCH_SHOTS}) in {seq_s:.2f} s sequential and {ahead_s:.2f} s "
            f"with decode-ahead ({seq_s - ahead_s:+.2f} s); every metrics.json equal "
            f"but {list(WALL_CLOCK_FIELDS)}; phases sequential {json.dumps(seq_phases)}; "
            f"phases decode-ahead {json.dumps(ahead_phases)}; {smi}")

        # (e) the aggregator over the output tree
        plots = []
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            plots = ["--no-plots"]
        buf = io.StringIO()
        with redirect_stdout(buf):
            aggregate.main(["sweep_adapter_gp", "--output-root", out, *plots])
        table = buf.getvalue()
        csv_path = os.path.join(out, "sweep_adapter_gp", "_tables", "Average.csv")
        log(table.rstrip())
        if "=== Dataset: Synthetic ===" not in table or not os.path.exists(csv_path):
            raise RuntimeError("aggregate: no table printed or no Average.csv written")
        with open(csv_path) as f:
            log(f"[sweep] aggregate: {csv_path} "
                f"({'tables only: no matplotlib' if plots else 'with plots'}): "
                f"{f.read().strip()!r}")
        torch.cuda.synchronize()
    return by_path


# phase 12: the sharded extraction against one device's, on ViT-B/16
MESH_ENCODE_TOL = 5e-5
# the native decode against PIL on generated JPEGs (tests/test_native_decode.py)
NATIVE_PIL_TOL = 4.0


def _native_check(smi, backbone):
    """``[native]``: the port's C++ JPEG decode, where it builds."""
    import io

    import numpy as np
    from PIL import Image

    from clip_gp_tpu_torch.data.transforms import center_crop, resize_shortest
    from clip_gp_tpu_torch.native import loader as native

    available = native.native_available()
    reason = native.unavailable_reason() or "none"
    reason = " | ".join(line.strip() for line in reason.splitlines() if line.strip())
    log(f"[native] available={available} reason={reason[-400:]!r}; {smi}")
    if not available:
        log("[native] not run: the 16-JPEG check against PIL and the CLI run with "
            "CLIP_GP_TPU_TORCH_NATIVE_DECODE=1 need the library; every image takes "
            "the Pillow path, as in the JAX package on such a host")
        return {}
    rng = np.random.default_rng(0)
    diffs, t_native, t_pil = [], 0.0, 0.0
    for i in range(16):
        w, h = int(rng.integers(240, 640)), int(rng.integers(240, 640))
        x = rng.normal(size=(h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(x, np.ones((8, 8, 1)))[:h, :w]
        img = ((img - img.min()) / (np.ptp(img) + 1e-9) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=95)
        jpeg = buf.getvalue()
        start = time.perf_counter()
        ours = native.decode_resize_crop(jpeg, 224)
        t_native += time.perf_counter() - start
        start = time.perf_counter()
        ref = center_crop(resize_shortest(Image.open(io.BytesIO(jpeg)).convert("RGB"),
                                          224, Image.BICUBIC), (224, 224))
        ref = np.asarray(ref, dtype=np.uint8)
        t_pil += time.perf_counter() - start
        if ours is None:
            raise RuntimeError(f"[native] JPEG {i} ({w}x{h}) did not decode")
        diffs.append(float(np.abs(ours.astype(np.int16) - ref.astype(np.int16)).mean()))
    if max(diffs) >= NATIVE_PIL_TOL:
        raise RuntimeError(f"[native] mean |native - PIL| {max(diffs)} >= {NATIVE_PIL_TOL}")
    log(f"[native] 16 JPEGs at 224: mean |native - PIL| at most {max(diffs):.3f} "
        f"(limit {NATIVE_PIL_TOL}); native {1e3 * t_native / 16:.3f} ms and PIL "
        f"{1e3 * t_pil / 16:.3f} ms per image on the host; {smi}")

    import clip_gp_tpu_torch.native as native_pkg
    from clip_gp_tpu_torch import train as train_main
    from clip_gp_tpu_torch.data import pipeline
    from clip_gp_tpu_torch.data.datasets.synthetic import generate_synthetic_imagefolder
    from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES

    res = ARCHITECTURES[backbone].image_resolution
    calls = []
    real = native_pkg.decode_resize_crop

    def counted(data, target):
        calls.append(target)
        return real(data, target)

    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_imagefolder(tmp, fmt="jpg")
        os.environ["CLIP_GP_TPU_TORCH_NATIVE_DECODE"] = "1"
        _reset_counts()
        try:
            with mock.patch.object(pipeline, "_USE_NATIVE", True), \
                    mock.patch.object(native_pkg, "decode_resize_crop", counted):
                train_main.main([
                    "--dataset", "Synthetic", "--root", tmp, "--shots", "2",
                    "--backbone", backbone, "--seed", "1",
                    "--output-dir", os.path.join(tmp, "run"), "--batch-size", "8",
                    "--num-templates", "2", "INPUT.SIZE", f"({res}, {res})",
                    "INPUT.TRANSFORMS", "['normalize']",
                    "TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "1",
                    # decode in this process, where the patch counts the calls
                    "DATALOADER.NUM_WORKERS", "0"])
        finally:
            os.environ.pop("CLIP_GP_TPU_TORCH_NATIVE_DECODE", None)
        launches = _counts()
        with open(os.path.join(tmp, "run", "metrics.json")) as f:
            metrics = json.load(f)["metrics"]
    if not calls or not math.isfinite(metrics["top1_acc"]):
        raise RuntimeError(f"[native] CLI run: {len(calls)} native decodes, {metrics}")
    log(f"[native] CLI run on a Synthetic JPEG tree with "
        f"CLIP_GP_TPU_TORCH_NATIVE_DECODE=1: {len(calls)} images decoded natively, "
        f"top-1 {metrics['top1_acc']:.2f}; {smi}")
    return {"native_cli": launches}


def _cross_device_k1(devices):
    """K1 from a thread whose current device is ``devices[0]``, on tensors
    of ``devices[1]``, against its plain version there: the largest error."""
    import threading

    import torch

    from clip_gp_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    b, n, d, heads = 3, 77, 512, 8

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(devices[1])

    args = (rnd(b, n, d), 1 + 0.1 * rnd(d), 0.1 * rnd(d), rnd(d, 3 * d, scale=d**-0.5),
            0.1 * rnd(3 * d), rnd(d, d, scale=d**-0.5), 0.1 * rnd(d), heads, None)
    out = {}

    def run():
        torch.cuda.set_device(devices[0])
        with torch.no_grad():
            out["k1"] = fa.fused_ln_attention_block(*args)
        torch.cuda.synchronize(devices[1])

    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "k1" not in out or out["k1"].device != devices[1]:
        raise RuntimeError(f"cross-device K1: no output on {devices[1]}")
    with torch.no_grad():
        ref = fa.ln_attention_block_plain(*args)
    return float((out["k1"] - ref).abs().max())


def phase_multi(smi, backbone="ViT-B/16"):
    """Phase 12: the native JPEG decode, then multi-device placement through
    the sweep (``--group-parallel``, ``--trial-mesh``) and, with two or more
    devices, the sharded extraction and a cross-device launch. Returns the
    launches of each run in this process."""
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from clip_gp_tpu_torch.core.device import local_devices
    from clip_gp_tpu_torch.data.datasets.synthetic import generate_synthetic_imagefolder

    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    by_path = _native_check(smi, backbone)
    devices = local_devices()
    log(f"[multi-gpu] devices={len(devices)}; {smi}")
    k1, k2 = "fused_ln_attention_block", "fused_ln_mlp"
    with tempfile.TemporaryDirectory() as tmp:
        small, out = os.path.join(tmp, "small"), os.path.join(tmp, "out")
        generate_synthetic_imagefolder(small)
        gp = dict(TRAINER={"ADAPTER": {"CLIP_ADAPTER_EPOCHS": 10}})
        path = _experiment_yaml(os.path.join(tmp, "multi.yaml"), "gp.yaml", small, out,
                                "multi", backbone, SWEEP_SEEDS, SWEEP_PREFETCH_SHOTS, {},
                                **gp)
        runs = {}
        # in turns, so that neither schedule alone pays a first run's cost
        for name, flags in (("sequential", ["--group-parallel", "1"]),
                            ("group_parallel", ["--group-parallel", "2"]),
                            ("trial_mesh_auto", ["--trial-mesh", "auto"]),
                            ("trial_mesh_2", ["--trial-mesh", "2"]),
                            ("group_parallel_again", ["--group-parallel", "2"]),
                            ("sequential_again", ["--group-parallel", "1"])):
            if name == "trial_mesh_2" and len(devices) < 2:
                continue
            tee = _Tee(sys.stdout)
            with redirect_stdout(tee):
                results, launches, phases, seconds = _sweep_run(
                    path, "--backend", "vmap", "--strict-vmap", "--no-skip-logged",
                    *flags)
            _vmapped(f"multi ({name})", results, 4 * len(SWEEP_PREFETCH_SHOTS))
            runs[name] = (_trial_payloads(results), launches, seconds, tee.text())
            by_path[f"multi_{name}"] = launches
        seq, seq_launches, seq_s, _ = runs["sequential"]
        # one device: --trial-mesh auto runs unsharded, so equal bit for bit;
        # on several it shards, and is held to the sequential run as
        # --trial-mesh 2 is, below
        exact = ["group_parallel", "group_parallel_again", "sequential_again"] + (
            ["trial_mesh_auto"] if len(devices) == 1 else [])
        for name in list(runs)[1:]:
            if name not in runs:
                continue
            payloads, launches, seconds, text = runs[name]
            differ = sorted({f"{key}:{field}" for key in seq for field in seq[key]
                             if seq[key][field] != payloads.get(key, {}).get(field)})
            if name in exact and (set(seq) != set(payloads) or differ):
                raise RuntimeError(f"multi ({name}): metrics.json differs from the "
                                   f"sequential run: {differ}")
            if (launches[k1], launches[k2]) != (seq_launches[k1], seq_launches[k2]):
                raise RuntimeError(f"multi ({name}): K1/K2 {launches[k1]}/{launches[k2]} "
                                   f"against {seq_launches[k1]}/{seq_launches[k2]} "
                                   "sequential")
        gp_text = runs["group_parallel"][3]
        want = (f"scheduling 2 trial group(s) over 2 worker(s) / {len(devices)} "
                "device(s)")
        if want not in gp_text:
            raise RuntimeError(f"multi (group_parallel): no '{want}' line")
        mesh_text = runs["trial_mesh_auto"][3]
        if len(devices) == 1 and "running unsharded" not in mesh_text:
            raise RuntimeError("multi (trial_mesh_auto): no 'running unsharded' line")
        seq2_s, gp_s, gp2_s, mesh_s = (runs[n][2] for n in (
            "sequential_again", "group_parallel", "group_parallel_again",
            "trial_mesh_auto"))
        log(f"[multi-gpu] {len(seq)} trials in 2 GP groups (shots "
            f"{SWEEP_PREFETCH_SHOTS}, T=4), in turns: one after another {seq_s:.2f} "
            f"and {seq2_s:.2f} s, --group-parallel 2 {gp_s:.2f} and {gp2_s:.2f} s "
            f"({(gp_s + gp2_s) / (seq_s + seq2_s):.3f}x), --trial-mesh auto "
            f"{mesh_s:.2f} s; metrics.json equal to the first sequential run's but "
            f"{list(WALL_CLOCK_FIELDS)} in {sorted(exact)}; K1/K2 "
            f"{seq_launches[k1]}/{seq_launches[k2]} in each run; {smi}")
        for name in ("trial_mesh_auto", "trial_mesh_2") if len(devices) >= 2 else ():
            payloads = runs[name][0]
            worst = 0.0
            for key, want_p in seq.items():
                got, ref = payloads[key]["metrics"], want_p["metrics"]
                if got["top1_acc"] != ref["top1_acc"]:
                    raise RuntimeError(f"multi ({name}): top-1 {got['top1_acc']} "
                                       f"against {ref['top1_acc']} unsharded ({key})")
                worst = max([worst] + [abs(got[m] - ref[m])
                                       for m in ("ece", "aece", "macro_f1")])
            if worst > SWEEP_METRIC_TOL:
                raise RuntimeError(f"multi ({name}): metrics off by {worst}")
            log(f"[multi-gpu] {name}: top-1 equal to the sequential run, metrics "
                f"within {worst:.3g}; {runs[name][2]:.2f} s; {smi}")
    if len(devices) >= 2:
        from clip_gp_tpu_torch.data.transforms import device_preprocess
        from clip_gp_tpu_torch.models.clip_loader import init_clip_params
        from clip_gp_tpu_torch.models.clip_model import ARCHITECTURES
        from clip_gp_tpu_torch.parallel.mesh import maybe_sharded_encode

        arch = ARCHITECTURES[backbone]
        model = init_clip_params(arch, seed=0, device=devices[0])
        res = arch.image_resolution
        images = np.random.default_rng(0).integers(0, 256, size=(33, res, res, 3),
                                                   dtype=np.uint8)

        def encode_on(visual, u8):
            with torch.no_grad():
                return visual(device_preprocess(u8)).float()

        sharded = maybe_sharded_encode(encode_on, model.visual, devices=devices)
        got = sharded(images)
        with torch.no_grad():
            want = model.encode_image(device_preprocess(
                torch.from_numpy(images).to(devices[0])))
        err = float((got - want).abs().max())
        if err > MESH_ENCODE_TOL:
            raise RuntimeError(f"sharded extraction off by {err} > {MESH_ENCODE_TOL}")
        k1_err = _cross_device_k1(devices)
        if k1_err > 1e-4:
            raise RuntimeError(f"cross-device K1 off by {k1_err}")
        log(f"[multi-gpu] sharded extraction of 33 images over {len(devices)} devices "
            f"against one device: max |diff| {err:.3g} (limit {MESH_ENCODE_TOL}); K1 "
            f"from a thread on {devices[0]} for tensors on {devices[1]}: max |diff| "
            f"{k1_err:.3g} against its plain version; {smi}")
    else:
        log("[multi-gpu] not run with one device: the sharded extraction, "
            "--trial-mesh 2 and the cross-device K1 launch each need a second "
            "device; --group-parallel 2 ran two co-resident groups on the one "
            "device and --trial-mesh auto ran each group unsharded")
    torch.cuda.synchronize()
    return by_path



# ---------------------------------------------------------------------------
# phase 13
# ---------------------------------------------------------------------------

SCRIPTS_INT8_COS = 0.999
SCRIPTS_GRAD_TOL = 1e-4


def _caltech_tree(root, per_class=16, size=64):
    """A Caltech101-layout tree (``caltech-101/101_ObjectCategories``): two
    classes and the two folders the catalog ignores."""
    for folder in ("airplanes", "Faces", "BACKGROUND_Google", "Faces_easy"):
        _write_pngs(os.path.join(root, "caltech-101", "101_ObjectCategories", folder),
                    per_class, size)


def phase_scripts(smi, pt):
    """Phase 13: every module of ``clip_gp_tpu_torch.scripts`` through its
    ``run(...)`` at full width (ViT-B/16 and RN50 towers) with classes,
    images, epochs and steps cut, each report printed as a ``[scripts]``
    line; ``pt`` is the random RN50 ``.pt`` of phase 9, which the parity
    harness converts. Returns the launches of the whole phase (path
    ``scripts``)."""
    import contextlib
    import io

    import torch

    from clip_gp_tpu_torch.scripts import (
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
        parity_check,
        profile_vmap_group,
        quick_check,
    )

    def quiet(fn, *args, **kwargs):
        """``fn``'s report, its own output kept off the smoke's."""
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            return fn(*args, **kwargs)

    def line(name, report, seconds):
        log(f"[scripts] {name} ({seconds:.2f} s) {json.dumps(report)}; {smi}")

    runs = [
        ("bench_backbones", bench_backbones.run, dict(
            backbones=("ViT-B/16", "RN50"), batches=(128,))),
        ("bench_int8_encode", bench_int8_encode.run, dict(
            batch=64, timed_iters=5, windows=2, archs=("ViT-B/16",))),
        ("bench_gp", bench_gp.run, dict(epochs=10, timed_steps=5)),
        ("bench_trial", bench_trial.run, dict(
            num_classes=4, images_per_class=12, shots=4, epochs=3)),
        ("profile_vmap_group", profile_vmap_group.run, dict(
            shots=2, classes=4, images_per_class=12, epochs=3)),
        ("bench_sweep", bench_sweep.run, dict(
            num_classes=4, images_per_class=12, shots=4, epochs=3)),
        ("bench_coop_vmap", bench_coop_vmap.run, dict(
            epochs=1, classes=10, shots=1, images_per_class=4)),
        ("bench_cocoop_vmap", bench_cocoop_vmap.run, dict(
            epochs=1, classes=10, shots=1, images_per_class=4)),
        ("bench_cocoop", bench_cocoop.run, dict(steps=1)),
        ("bench_cocoop_profile", bench_cocoop_profile.run, dict(
            steps=1, eval_rows=32)),
        ("bench_fused_vjp", bench_fused_vjp.run, dict(t=2, k=50, steps=2, reps=1)),
        ("bench_sweep_methods", bench_sweep_methods.run, dict(
            seeds=[1, 2], shots=[1], epochs=1, prompt_epochs=1, smoke=True)),
        ("bench_cocoop_imagenet_scale", bench_cocoop_imagenet_scale.run, dict(
            seeds=[1, 2], classes=100)),
        # decode-ahead runs in phase 11
        ("bench_sweep_projection", bench_sweep_projection.run, dict(
            shots=(1, 2), classes=10, images_per_class=12, epochs=3,
            decode_ahead=False)),
    ]
    os.environ["CLIP_GP_TPU_TORCH_ALLOW_RANDOM_WEIGHTS"] = "1"
    start = time.perf_counter()
    _reset_counts()
    t0 = time.perf_counter()
    report = quiet(quick_check.run, backbone="ViT-B/16", epochs=1)
    line("quick_check", report, time.perf_counter() - t0)
    if not all(report["results"].values()):
        raise RuntimeError(f"quick_check: {report['results']}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        npz = quiet(parity_check.convert, pt, os.path.join(tmp, "RN50.npz"))
        convert_s = time.perf_counter() - t0
        _caltech_tree(tmp)
        argv = dict(root=tmp, output_root=os.path.join(tmp, "parity"),
                    opts=["TRAINER.ADAPTER.CLIP_ADAPTER_EPOCHS", "2",
                          "TRAINER.ADAPTER.NUM_TEMPLATES", "2",
                          "MODEL.INIT_WEIGHTS", npz])
        first = quiet(parity_check.run, 1, **argv)
        trial = parity_check.parity_trials(1)[0]["name"]
        with open(os.path.join(tmp, "parity", trial, "metrics.json")) as f:
            metrics = json.load(f)["metrics"]
        os.makedirs(os.path.join(tmp, "ref", trial))
        with open(os.path.join(tmp, "ref", trial, "metrics.json"), "w") as f:
            json.dump({"metrics": {"top1_acc": metrics["top1_acc"] + 0.2,
                                   "ece": metrics["ece"] - 0.1,
                                   "aece": metrics["aece"]}}, f)
        report = quiet(parity_check.run, 1, reference_root=os.path.join(tmp, "ref"),
                       **argv)
        line("parity_check", {"convert": os.path.basename(npz),
                              "convert_s": round(convert_s, 2),
                              "no_ref": first["trials"], **report},
             time.perf_counter() - t0)
        if ([s for _, s, _ in first["trials"]] != ["NO-REF"]
                or [s for _, s, _ in report["trials"]] != ["OK"]):
            raise RuntimeError(f"parity_check: {first['trials']} then {report['trials']}")
    for name, run, kwargs in runs:
        t0 = time.perf_counter()
        report = quiet(run, **kwargs)
        line(name, report, time.perf_counter() - t0)
        cosines = [v for k, v in report.items() if k.endswith("_min_cosine")]
        if name == "bench_int8_encode" and min(cosines) < SCRIPTS_INT8_COS:
            raise RuntimeError(f"int8 against bf16 features: cosine {min(cosines)} "
                               f"< {SCRIPTS_INT8_COS}")
        if name == "bench_fused_vjp" and report["grad_max_rel_err"] > SCRIPTS_GRAD_TOL:
            raise RuntimeError(f"bench_fused_vjp: kernels against library gradients "
                               f"{report['grad_max_rel_err']} > {SCRIPTS_GRAD_TOL}")
    torch.cuda.synchronize()
    launches = _counts()
    log(f"[scripts] phase 13 took {time.perf_counter() - start:.2f} s; {smi}")
    # K1-K6; K7 and K8 run only in phase 2's cells
    _check_launches("scripts", launches, {name: 1 for name in (
        "fused_ln_attention_block", "fused_ln_mlp", "ln_attn_bwd", "ln_mlp_bwd",
        "q8_ln_attention_block", "q8_ln_mlp")})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import clip_gp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the clip_gp_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    device, smi = phase_build()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    cells = (phase_kernels(device, peaks) + phase_bwd_kernels(device, peaks)
             + phase_q8_kernels(device, peaks)
             + phase_attention_kernels(device, peaks))
    phase_q8_gemm(device, peaks)
    phase_core_sweep(device)
    phase_attention_bwd_sweep(device)
    phase_gemm_sweep(device)
    phase_gemm_bwd_sweep(device)
    phase_profile(device)
    phase_towers(device)
    by_path = {"adapter_gp": phase_trainer(), "coop": phase_coop(),
               "cocoop": phase_cocoop(), **phase_serving(device),
               "blocks": phase_blocks(device)}
    with tempfile.TemporaryDirectory() as tmp:
        pt = os.path.join(tmp, "RN50.pt")
        torch.save(rn50_state_dict()[1], pt)
        by_path["rn50_encode"] = phase_rn50_tower(device, smi, pt)
        by_path.update(phase_rn50_trainers(pt))
        by_path["vit_clip_adapter"] = phase_vit_clip_adapter()
        by_path.update(phase_single_trial())
        by_path.update(phase_sweep(smi))
        by_path.update(phase_multi(smi))
        by_path["scripts"] = phase_scripts(smi, pt)
    for cell in cells:
        counts = {path: launches[cell["kernel"]] for path, launches in by_path.items()}
        cell["launches"] = sum(counts.values())
        cell["launches_by_path"] = counts
    log(json.dumps({"kernels": cells}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
