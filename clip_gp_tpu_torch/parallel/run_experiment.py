"""Thin wrapper over the sweep runner, the port's counterpart of
``scripts/run_experiment.sh`` (ref: scripts/run_experiment.sh).

Usage: ``python -m clip_gp_tpu_torch.parallel.run_experiment <experiment-yaml>
[extra sweep args...]``, e.g. ``--backend vmap --strict-vmap`` or
``--backend subprocess --devices 0,1``.
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        print(
            "Usage: python -m clip_gp_tpu_torch.parallel.run_experiment "
            "<experiment-yaml> [--backend inprocess|subprocess|vmap] "
            "[--devices ...]",
            file=sys.stderr,
        )
        return 1
    from clip_gp_tpu_torch.parallel import sweep

    sweep.main(["--config-file", argv[0]] + argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
