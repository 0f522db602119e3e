"""Milliseconds per trial-batched GP step: the program's ``vmap.train.step``
phase timer (each epoch's steps, ended by a synchronize) over the steps."""

from port_bench import reading


def read(record):
    groups = reading.untraced(record["groups"])
    steps = sum(g["steps"] for g in groups)
    return 1000.0 * reading.phase(groups, "vmap.train.step") / steps if steps else None
