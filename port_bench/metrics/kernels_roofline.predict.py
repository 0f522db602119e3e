"""Percent of their roofline that the traced job's K1 and K2 calls
(``fused_ln_attention_block``, ``fused_ln_mlp``) reach: each call's least
time, the larger of its operations over the fp32-input peak and its bytes
over HBM's bandwidth (``flops.py``, the calls counted by the port's
``LAUNCHES``, their images spread evenly over them), summed, over the device
time of the port's own kernels in the trace."""

from port_bench import flops, reading


def read(record):
    ctx = record["cell"]
    job = next((j for j in record["jobs"] if j.get("trace") is not None), None)
    if job is None or ctx.device.type != "cuda":
        return None
    seconds = reading.port_kernel_seconds(job["trace"], reading.port_kernels())
    cfg = ctx.config
    n = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    d = cfg["vision_width"]
    bound = 0.0
    for name, block in (("fused_ln_attention_block", flops.ln_attention_block),
                        ("fused_ln_mlp", flops.ln_mlp_block)):
        calls = job["launches"].get(name, 0)
        if calls:
            b = job["images"] * cfg["vision_layers"] / calls
            bound += calls * flops.bound_seconds(*block(b, n, d))
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
