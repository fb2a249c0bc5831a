"""attn_roofline_pct.flux: kernel A's share of its roofline. Over A's
launches in the traced window (the RoPE pre-pass and the forward), the sum
of each one's least time (counts/flux.attention_launch and rope_launch at
the call's batch, L = image tokens + T5's, 24 heads of 128), over their
device time, in percent. Nothing is read unless the launches counted in
the trace are the ones the calls need (one pre-pass and one forward a
block a step)."""

from benchmark.counts.flux import attention_launch, rope_launch
from benchmark.counts.peaks import bound_s

FORWARD = ("flash_fwd_sm90_kernel", "flash_fwd_d64_kernel")
PREPASS = ("rope_rotate_kernel",)


def read(ctx):
    tl, flow = ctx.timeline, ctx.config["flow"]
    if tl is None or not ctx.calls:
        return None
    q = ctx.traffic
    length = (q["height"] // 16) * (q["width"] // 16) + ctx.config["t5_max_length"]
    heads, dim = flow["num_heads"], flow["hidden_size"] // flow["num_heads"]
    blocks = flow["depth"] + flow["depth_single_blocks"]
    launches = sum(steps * blocks for _, steps in ctx.calls)
    least = sum(steps * blocks * (bound_s(*attention_launch(n, length, heads, dim)) +
                                  bound_s(*rope_launch(n, length, heads, dim))) for n, steps in ctx.calls)

    def fwd(o):
        return any(k in o.name for k in FORWARD)

    def pre(o):
        return any(k in o.name for k in PREPASS)

    if tl.count(fwd) != launches or tl.count(pre) != launches:
        return None
    return 100.0 * least / tl.device_time(lambda o: fwd(o) or pre(o))
