"""One NVIDIA H100 SXM's published dense peaks (NVIDIA's data sheet, at the
full 700 W power limit), and the least time a piece of work can take."""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """The least seconds for `flops` operations at `peak` and `nbytes` at the
    card's memory rate: the larger of the two."""
    return max(flops / peak, nbytes / PEAK_BYTES_S)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least ms, "operations" or "bytes"): which of the two bounds it."""
    ops_s, bytes_s = flops / peak, nbytes / PEAK_BYTES_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")
