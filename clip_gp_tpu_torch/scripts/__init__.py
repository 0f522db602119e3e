"""The JAX package's ``scripts/`` on the port: one module per script, under
the same file name, run from the repository root as
``python -m clip_gp_tpu_torch.scripts.<name>`` with the JAX script's flags
and ``BENCH_*`` knobs (its ``CLIP_GP_TPU_*`` knobs are spelled
``CLIP_GP_TPU_TORCH_*``). Each module has a ``run(...)`` whose keyword
defaults are the JAX script's sizes and which returns the report, and a
``main(argv=None)`` that prints the report as one JSON line and returns the
exit code. Every report names the card it ran on (``core.device.
device_label``: ``nvidia-smi``'s name and power limit) or ``"cpu"``. They
run on the GPU; ``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` runs them on the CPU.
Artifacts go to ``build/scripts/``. A timed window ends with
``torch.cuda.synchronize()``. No script catches an error but the card's
out-of-memory error, and none retries.

- ``quick_check``: every method for a few epochs (all eight rows);
- ``parity_check``: the BASELINE parity configs against reference
  metrics.json artifacts, and ``--convert`` of an OpenAI ``.pt`` to npz;
- ``bench_backbones``: encode throughput of the six towers in bf16;
- ``bench_int8_encode``: the bf16 ViT tower (K1/K2) against the int8 one
  (K5/K6);
- ``bench_gp``: one Adapter+GP step, a 100-epoch fit and an S=300 eval;
- ``bench_trial``: one flagship trial with its phase report;
- ``profile_vmap_group``: one trial-batched group's phase report;
- ``bench_sweep``: 5 seeds × 2 GP betas as one group;
- ``bench_coop_vmap``, ``bench_cocoop_vmap``: a trial-batched prompt
  group against in-process trials;
- ``bench_cocoop``: a CoCoOp step at the prompt budget against B·K;
- ``bench_cocoop_profile``: a CoCoOp step's parts per tower dtype;
- ``bench_fused_vjp``: the differentiated text tower, kernels against a
  tower of library calls;
- ``bench_sweep_methods``: the BASELINE #3/#4 cells, trial-batched;
- ``bench_cocoop_imagenet_scale``: CoCoOp at K=1000, T=5, with its peak
  device memory;
- ``bench_sweep_projection``: one group per shot count, projected over the
  host's cards.

Not ported, each because what it measures exists only on the TPU:

- ``bench_mxu_dtypes.py`` probes the MXU's rate per dtype through XLA; the
  card's int8 and bf16 product rates are ``chip_smoke.py``'s
  ``[int8 gemm]`` and ``[gemm tiles]`` cells;
- ``calibrate_dispatch.py`` calibrates the TPU worker's ~60 s
  single-dispatch ceiling (the duration half of ``dispatch_budget`` is not
  ported: a CUDA stream has no such ceiling);
- ``repro_cocoop_crash.py`` reproduces a crash of the TPU worker.

The rest already have their counterparts: ``run_experiment.sh`` is
``python -m clip_gp_tpu_torch.parallel.run_experiment``, ``predict.py`` is
``python -m clip_gp_tpu_torch.predict`` and ``ood_eval.py`` is
``python -m clip_gp_tpu_torch.ood_eval``.
"""
