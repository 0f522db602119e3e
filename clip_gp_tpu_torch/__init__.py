"""clip_gp_tpu_torch — the PyTorch/CUDA port of clip_gp_tpu for NVIDIA Hopper.

A second package beside the JAX one, with its layout and public names
(core/, data/, models/, ops/, gp/, methods/, runtime/). It imports torch and
never jax, and nothing of clip_gp_tpu. The frozen CLIP towers run every
transformer block through two hand-written CUDA kernels (csrc/, bound in
ops/flash_attention.py) built for sm_90a at first use. Entry points run on
the GPU unless the caller asks for the CPU (CLIP_GP_TPU_TORCH_FORCE_CPU=1 or
an explicit device), where each kernel's plain PyTorch version runs instead.

Ported so far: the single-trial ``train.py`` flow for every head, run as
``python -m clip_gp_tpu_torch.train`` (checkpoints, reference-format
checkpoints, TensorBoard, the feature cache, phase timing, Muon), the
serving entry ``python -m clip_gp_tpu_torch.predict`` and the OOD entry
``python -m clip_gp_tpu_torch.ood_eval``.
"""

__version__ = "0.1.0"
