"""Method registration: importing this package registers the ported trainers
(Adapter, Adapter-CoOp, Adapter-CoCoOp; the JAX package's CLIP-Adapter,
TaskRes and Tip-Adapter heads are not ported yet)."""

from clip_gp_tpu_torch.methods import adapter, cocoop, coop  # noqa: F401
