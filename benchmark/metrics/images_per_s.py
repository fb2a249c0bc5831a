"""images_per_s: images returned after the first completion inside the
window up to the last, over the time between the two."""

from benchmark.harness import rate


def read(ctx):
    return rate(ctx.records, ctx.close)[0]
