"""audio_s_per_s: seconds of audio (frames / 32000) returned after the first
completion inside the window up to the last, over the time between the two."""

from benchmark.harness import rate


def read(ctx):
    return rate(ctx.records, ctx.close)[0]
