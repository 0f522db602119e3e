"""Percent of the traced group's wall time in which no operation ran on the
device."""

from port_bench import reading


def read(record):
    if record["cell"].device.type != "cuda":
        return None
    return reading.idle_percent(reading.traced(record["groups"]))
