"""repack_ms.musicgen: device ms of the model's `fgt.musicgen.repack` spans
(kernel D's weights packed into its chunk stream, once a `generate` call,
between CUDA events) in the traced window, a call."""

from benchmark.spans import device_ms, recorded


def read(ctx):
    spans = recorded(ctx, "fgt.musicgen.repack")
    ms = device_ms(spans)
    return ms / len(spans) if ms is not None else None
