"""Percent of the traced job's device-busy time spent in the key-tiled
attention core (``attention_tiled_kernel``). None where the trace holds no
such kernel."""

from port_bench import reading

KERNEL = "attention_tiled_kernel"


def read(record):
    if record["cell"].device.type != "cuda":
        return None
    summary = reading.traced(record["jobs"])
    if summary is None or summary["busy_s"] <= 0:
        return None
    seconds = reading.port_kernel_seconds(summary, [KERNEL])
    return 100.0 * seconds / summary["busy_s"] if seconds > 0 else None
