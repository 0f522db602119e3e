"""Percent of the folder jobs' seconds in which the job's extraction waits
for the loader's next decoded batch: the program's ``data.wait_batch``
spans inside each untraced job's ``feature_extraction`` span, over those
jobs' seconds."""

from port_bench import program_spans


def read(record):
    log = program_spans.log()
    jobs = record["jobs"]
    found = None if log is None else log.jobs(len(jobs))
    if found is None:
        return None
    pairs = [(j, s) for j, s in zip(jobs, found) if j.get("trace") is None] or list(zip(jobs, found))
    waits = [w for _, s in pairs for w in log.inside(s, "data.wait_batch")]
    seconds = sum(j["seconds"] for j, _ in pairs)
    return 100.0 * program_spans.seconds(waits) / seconds if waits and seconds > 0 else None
