"""Device kernels per GP step: in the traced group, the kernels that start
between the benchmark's marks at the first and the last step's draw, per
step between them."""

from port_bench import reading


def read(record):
    summary = reading.traced(record["groups"])
    return None if summary is None else reading.kernels_between(summary, "port_bench.step")
