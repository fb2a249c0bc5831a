"""codec_ms.musicgen: device ms of the pipeline's `fgt.musicgen.codec` spans
(each sample's EnCodec decode, between CUDA events) in the traced window, a
second of audio returned."""

from benchmark.spans import device_ms, recorded, served


def read(ctx):
    ms, seconds = device_ms(recorded(ctx, "fgt.musicgen.codec")), served(ctx)
    return ms / seconds if ms is not None and seconds else None
