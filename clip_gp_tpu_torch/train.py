"""CLI entry point — flag- and flow-compatible with the JAX package's
``train.py`` (and the reference's, ref: train.py:57-107): parse config →
logger (log.txt tee) → seed → data manager → trainer → train / eval-only /
no-train.

Run as ``python -m clip_gp_tpu_torch.train [flags] [OPTS...]``. It runs on
the GPU; ``CLIP_GP_TPU_TORCH_FORCE_CPU=1`` runs it on the CPU.
``--eval-only --model-dir <run>`` rebuilds the trainer, reloads the run's
checkpoint (``--load-epoch``, else model-best, else the last) and writes
metrics.json for the test split; with ``MODEL.INT8_INFERENCE True`` its image
encodes run the int8 tower.
"""

from __future__ import annotations

import time
from pathlib import Path


def main(argv=None):
    from clip_gp_tpu_torch.core.config import (
        parse_args_to_config,
        print_config,
        save_config_to_file,
    )
    from clip_gp_tpu_torch.core.device import resolve_device
    from clip_gp_tpu_torch.core.logging import setup_logger
    from clip_gp_tpu_torch.core.registry import build_trainer
    from clip_gp_tpu_torch.core.seeding import set_random_seed
    from clip_gp_tpu_torch.data.pipeline import build_data_manager

    # register datasets + trainers
    import clip_gp_tpu_torch.data.datasets  # noqa: F401
    import clip_gp_tpu_torch.methods  # noqa: F401

    config = parse_args_to_config(argv)
    setup_logger(config.output_dir)
    print_config(config)

    if config.seed >= 0:
        print(f"Setting fixed seed: {config.seed}")
        set_random_seed(config.seed)

    try:
        save_config_to_file(config, str(Path(config.output_dir) / "config.json"))
    except OSError:
        pass

    device = resolve_device()
    print(f"Torch device: {device}")

    dm = build_data_manager(config)
    trainer = build_trainer(config, dm)
    if config.eval_only:
        trainer.build_model()
        trainer.load_model(config.model_dir, epoch=config.load_epoch)
        trainer.time_start = time.time()
        trainer.test()
        return
    if not config.no_train:
        trainer.train()


if __name__ == "__main__":
    main()
