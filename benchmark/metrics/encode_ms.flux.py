"""encode_ms.flux: host ms an image inside the engine's `fgt.engine.encode`
spans (each served image's PNG encode and base64) in the traced window."""

from benchmark.spans import recorded


def read(ctx):
    spans = recorded(ctx, "fgt.engine.encode")
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans) if spans else None
