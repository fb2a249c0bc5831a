"""batch_mean.musicgen: samples per `generate_requests` call the engine made
in the traced window, as the proxy counted them."""


def read(ctx):
    if not ctx.calls:
        return None
    return sum(c["samples"] for c in ctx.calls) / len(ctx.calls)
