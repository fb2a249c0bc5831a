"""cond_ms.flux: device ms of the pipeline's `fgt.flux.cond` spans (T5-XXL
and CLIP over a batch's prompts, between CUDA events) in the traced window,
an image served."""

from benchmark.spans import device_ms, recorded, served


def read(ctx):
    ms, images = device_ms(recorded(ctx, "fgt.flux.cond")), served(ctx)
    return ms / images if ms is not None and images else None
