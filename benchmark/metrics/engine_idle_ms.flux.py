"""engine_idle_ms.flux: device-idle time while the serving thread was
outside every call into the pipeline (PNG encoding, base64, the response,
the next admission), from the profiler's timeline and the proxy's ranges,
in ms an image."""

from benchmark.timeline import overlap


def read(ctx):
    tl = ctx.timeline
    images = sum(r.units for r in ctx.records if not r.error)
    if tl is None or not images:
        return None
    calls = [span for name in ctx.family.CALL_RANGES for span in tl.ranges.get(name, [])]
    gaps = tl.gaps()
    idle = sum(e - s for s, e in gaps) - overlap(gaps, calls)
    return 1e3 * idle / images
