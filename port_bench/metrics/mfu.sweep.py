"""Percent of the card's fp32-input peak (495 TFLOP/s, TF32) that the
window's model operations reach: every group's text encode, union encode,
GP steps and eval, counted from shapes (``flops.py``), over the seconds of
the sweeps that ran them (sweeps that ran without the profiler, where there
are any)."""

from port_bench import flops, harness


def read(record):
    ctx = record["cell"]
    if ctx.device.type != "cuda":
        return None
    gp_sweep = harness.driver("gp_sweep")
    plain = [s for s, rec in enumerate(record["sweeps"]) if not rec["traced"]]
    use = plain or list(range(len(record["sweeps"])))
    ops = sum(gp_sweep.group_flops(ctx.config, ctx.traffic, g)
              for g in record["groups"] if g["sweep"] in use)
    seconds = sum(record["sweeps"][s]["seconds"] for s in use)
    return 100.0 * ops / (seconds * flops.PEAK_FLOPS["float32"])
