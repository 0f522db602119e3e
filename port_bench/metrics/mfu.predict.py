"""Percent of the card's fp32-input peak (495 TFLOP/s, TF32) that the
served images' image-tower forward reaches, counted from shapes
(``flops.py``), over the jobs' seconds."""

from port_bench import flops, reading


def read(record):
    ctx = record["cell"]
    if ctx.device.type != "cuda":
        return None
    jobs = reading.untraced(record["jobs"])
    ops = sum(j["images"] for j in jobs) * flops.image_flops(ctx.config)
    return 100.0 * ops / (sum(j["seconds"] for j in jobs) * flops.PEAK_FLOPS["float32"])
