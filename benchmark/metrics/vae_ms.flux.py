"""vae_ms.flux: device ms of the pipeline's `fgt.flux.vae` spans (each
image's VAE decode to uint8, between CUDA events) in the traced window, an
image served."""

from benchmark.spans import device_ms, recorded, served


def read(ctx):
    ms, images = device_ms(recorded(ctx, "fgt.flux.vae")), served(ctx)
    return ms / images if ms is not None and images else None
