"""Method registration: importing this package registers the ported trainers
(Adapter, Adapter-CoOp, Adapter-CoCoOp, CLIP-Adapter, TaskRes and
Tip-Adapter, the last also as Tip-Adapter-F)."""

from clip_gp_tpu_torch.methods import (  # noqa: F401
    adapter,
    clip_adapter,
    cocoop,
    coop,
    taskres,
    tip_adapter,
)
