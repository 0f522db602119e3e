"""Percent of the folder jobs' batches that the loader had decoded before
the job asked for them: the program's ``data.decode_batch`` spans inside
each untraced job's ``feature_extraction`` span whose ``ready`` attribute
is true. None where the spans carry no ``ready`` (a loader that decodes
each batch when it is asked for)."""

from port_bench import program_spans


def read(record):
    log = program_spans.log()
    jobs = record["jobs"]
    found = None if log is None else log.jobs(len(jobs))
    if found is None:
        return None
    pairs = [(j, s) for j, s in zip(jobs, found) if j.get("trace") is None] or list(zip(jobs, found))
    handed = [d for _, s in pairs for d in log.inside(s, "data.decode_batch") if "ready" in d.attrs]
    return 100.0 * sum(bool(d.attrs["ready"]) for d in handed) / len(handed) if handed else None
