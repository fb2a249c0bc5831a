"""The program's own spans (`flux_generator_tpu_torch.runtime.profiling`),
as the per-layer metrics read them: those of one name that started inside
the traced window. A run without a profiler, or a program without the
recorder, gives none, and the metric reads nothing."""

from __future__ import annotations


def recorded(ctx, name: str) -> list:
    """The spans called `name` that started inside the traced window, each
    a dict (`start_ns`, `end_ns` on the profiler's clock; `device_ms` where
    the span took events; the attributes it kept)."""
    if ctx.timeline is None:
        return []
    from flux_generator_tpu_torch.runtime import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    lo, hi = ctx.timeline.window()
    return [s for s in read() if s["name"] == name and lo <= s["start_ns"] * 1e-9 <= hi]


def device_ms(spans: list):
    """The summed `device_ms` of spans that all took events, else None."""
    if not spans or any("device_ms" not in s for s in spans):
        return None
    return sum(s["device_ms"] for s in spans)


def served(ctx) -> float:
    """Units returned by the window's requests (images, audio seconds)."""
    return sum(r.units for r in ctx.records if not r.error)
