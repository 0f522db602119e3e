"""Percent of the traced folder job's device-idle seconds (the gaps between
its merged device ops) that lie inside the program's ``data.wait_batch``
spans, the job's extraction waiting for a decoded batch, on the profiler's
clock."""

from port_bench import program_spans


def read(record):
    if record["cell"].device.type != "cuda":
        return None
    log = program_spans.log()
    jobs = record["jobs"]
    found = None if log is None else log.jobs(len(jobs))
    if found is None:
        return None
    traced = [(j, s) for j, s in zip(jobs, found) if j.get("trace") is not None]
    if not traced:
        return None
    job, extraction = traced[0]
    return program_spans.idle_share(log, job["trace"], log.inside(extraction, "data.wait_batch"))
