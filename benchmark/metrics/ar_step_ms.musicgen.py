"""ar_step_ms.musicgen: the AR loop's seconds (`generate_requests`'
`trace["ar_s"]`, ended by a synchronize) over its steps, in ms a step."""


def read(ctx):
    steps = sum(c["steps"] for c in ctx.calls)
    return 1e3 * sum(c["ar_s"] for c in ctx.calls) / steps if steps else None
