"""device_idle_pct.musicgen: the share of the traced window in which no device
operation ran, in percent."""


def read(ctx):
    tl = ctx.timeline
    return None if tl is None else 100.0 * (1.0 - tl.busy_s() / tl.window_s())
