"""Percent of the traced group's device-idle seconds (the gaps between its
merged device ops) that lie inside the program's ``vmap.step`` spans: the
device waiting while the host issues a GP step, on the profiler's clock."""

from port_bench import program_spans


def read(record):
    if record["cell"].device.type != "cuda":
        return None
    log = program_spans.log()
    rec = next((g for g in record["groups"] if g.get("trace") is not None), None)
    group = None if log is None or rec is None else log.group(rec)
    if group is None:
        return None
    return program_spans.idle_share(log, rec["trace"], log.inside(group, "vmap.step"))
