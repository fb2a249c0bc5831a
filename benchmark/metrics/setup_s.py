"""setup_s: seconds from the process's start to the window's start: imports,
the seeded weights drawn on the card, kernel builds (the first run in a
checkout) and the warm-up request."""


def read(ctx):
    return ctx.setup_s
