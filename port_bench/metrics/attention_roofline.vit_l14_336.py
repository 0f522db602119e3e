"""Percent of its roofline that the key-tiled attention core of
``csrc/attention.cu`` (``attention_tiled_kernel``, K1's core past 256 tokens)
reaches in the traced job: each call's least time, the larger of its
operations over the fp32-input peak (495 TFLOP/s, TF32, as ``flops.py``
counts fp32 products) and its bytes over HBM's bandwidth, times the calls
(the port's ``LAUNCHES["key_tiled_attention"]``, the job's images spread
evenly over them), over that kernel's own device time in the trace. None
where the program has no such counter or kernel."""

from port_bench import flops, reading

KERNEL = "attention_tiled_kernel"


def core(b: int, n: int, d: int):
    """(operations, bytes) of one call of the core on [b, n, d]: the two
    products Q.K^T and P.V over every head (4·b·n²·d); qkv [b, n, 3d] read
    once and the output [b, n, d] written once, fp32."""
    return 4 * b * n * n * d, 4 * (3 * b * n * d + b * n * d)


def read(record):
    ctx = record["cell"]
    job = next((j for j in record["jobs"] if j.get("trace") is not None), None)
    if job is None or ctx.device.type != "cuda":
        return None
    calls = job["launches"].get("key_tiled_attention", 0)
    seconds = reading.port_kernel_seconds(job["trace"], [KERNEL])
    if not calls or seconds <= 0:
        return None
    cfg = ctx.config
    n = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    b = job["images"] * cfg["vision_layers"] / calls
    bound = calls * flops.bound_seconds(*core(b, n, cfg["vision_width"]))
    return 100.0 * bound / seconds
