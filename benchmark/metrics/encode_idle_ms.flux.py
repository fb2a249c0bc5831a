"""encode_idle_ms.flux: device-idle ms an image inside the engine's
`fgt.engine.encode` spans, the recorder's intervals laid over the traced
window's gaps in device activity. The intervals come from the recorder, not
from the serving thread's ranges, so the metric holds on whatever thread
the encode runs."""

from benchmark.spans import recorded
from benchmark.timeline import overlap


def read(ctx):
    spans = recorded(ctx, "fgt.engine.encode")
    if not spans:
        return None
    encode = [(s["start_ns"] * 1e-9, s["end_ns"] * 1e-9) for s in spans]
    return 1e3 * overlap(encode, ctx.timeline.gaps()) / len(spans)
