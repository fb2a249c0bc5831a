"""decode_attn_ms.musicgen: kernel D's self-attention phase, from block 0's
device-clock stamps after each grid sync in the served AR loop (the
`fgt.musicgen.ar` spans' `d_phase_ms`, summed over the 48 layers), in ms a
step over every step of the traced window."""

from benchmark.spans import recorded

PHASE = "self-attention"


def read(ctx):
    spans = [s for s in recorded(ctx, "fgt.musicgen.ar") if "d_phase_ms" in s]
    steps = sum(len(s["d_step_ms"]) for s in spans)
    return sum(s["d_phase_ms"][PHASE] for s in spans) / steps if steps else None
