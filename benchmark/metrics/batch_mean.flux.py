"""batch_mean.flux: images per pipeline call the engine made in the traced
window, as the proxy in the engine's pipeline slot counted them."""


def read(ctx):
    if not ctx.calls:
        return None
    return sum(n for n, _ in ctx.calls) / len(ctx.calls)
