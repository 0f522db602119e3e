"""Milliseconds the host takes to issue one trial-batched GP step: the mean
of the program's ``vmap.step`` spans (no synchronize) over the untraced
groups of the window. Near ``gp_step_ms.sweep``, the step is bound by its
launches."""

from port_bench import program_spans, reading


def read(record):
    log = program_spans.log()
    if log is None:
        return None
    steps = []
    for g in reading.untraced(record["groups"]):
        group = log.group(g)
        if group is None:
            return None
        steps += log.inside(group, "vmap.step")
    return 1000.0 * program_spans.seconds(steps) / len(steps) if steps else None
