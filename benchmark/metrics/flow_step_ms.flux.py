"""flow_step_ms.flux: device time of the operations launched inside the
flow's step ranges (each of the batched generator's steps), in ms an
image-step."""


def read(ctx):
    tl = ctx.timeline
    image_steps = sum(n * steps for n, steps in ctx.calls)
    if tl is None or not image_steps:
        return None
    return 1e3 * tl.device_time(lambda o: o.range in ctx.family.FLOW_RANGES) / image_steps
