"""Seconds a sweep group's union encode waits for decoded batches: the
program's ``data.wait_batch`` spans inside its ``vmap.union_encode`` span
(the decode itself, or decode-ahead's buffer running dry), per untraced
group of the window."""

from port_bench import program_spans, reading


def read(record):
    log = program_spans.log()
    if log is None:
        return None
    waits = []
    for g in reading.untraced(record["groups"]):
        group = log.group(g)
        unions = [] if group is None else log.inside(group, "vmap.union_encode")
        if not unions:
            return None
        waits.append([w for u in unions for w in log.inside(u, "data.wait_batch")])
    if not waits or not any(waits):
        return None
    return sum(program_spans.seconds(w) for w in waits) / len(waits)
