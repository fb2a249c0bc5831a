"""gemm_roofline_pct.flux: the flow's dense products (counts/flux.
denoise_flops, per image-step) over the device time of the GEMM kernels
launched inside the flow's step ranges at the bf16 peak, in percent. The
GEMM kernels are told by the names cuBLAS gives them on Hopper (PATTERN)."""

import re

from benchmark.counts.flux import denoise_flops
from benchmark.counts.peaks import PEAK_BF16_FLOPS

PATTERN = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|s16816|Kernel2", re.IGNORECASE)
NOT_GEMM = re.compile(r"flash|rope|splitKreduce", re.IGNORECASE)


def read(ctx):
    tl = ctx.timeline
    if tl is None or not ctx.calls:
        return None
    q = ctx.traffic
    dense, _ = denoise_flops(ctx.config["flow"], (q["height"] // 16) * (q["width"] // 16), ctx.config["t5_max_length"])
    flops = dense * sum(n * steps for n, steps in ctx.calls)
    seconds = tl.device_time(lambda o: o.range in ctx.family.FLOW_RANGES and PATTERN.search(o.name)
                             and not NOT_GEMM.search(o.name))
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS) if seconds else None
