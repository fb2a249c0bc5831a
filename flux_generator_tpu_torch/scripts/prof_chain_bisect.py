"""Time the chain-bisect probe (kernel #12) on the card, rung by rung.

    python -m flux_generator_tpu_torch.scripts.prof_chain_bisect [--extras smem,ln] [--ladder]
        [--layers 48] [--steps 50] [--chunk 512] [--window 512]

The port's counterpart of scripts/prof_chain_bisect.py: the decode-chain
probe's weight stream (#11 on kernel D's machinery: L × 14 int8 (1536,
1536) chunks with bf16 scales, tanh GELU) with the fused decode step's
structural pieces added, each built as D builds it (--extras, a comma list
of smem, ln, cross, hbm, bufs, outs, dma; --ladder runs the script's ladder
instead), so that each piece's cost in D shows, at 8 rows (the script's)
and at 2 (one music request's CFG rows).
The operands are seeded random: #11's weights and rows
(prof_decode_chain.make_inputs), finite LN params, cross K/V and caches.

For each rung it prints max|kernel - plain| against TOL of max|y| (and of
max|kn|, max|vn| with outs), the bytes the step must move and their bound at
the card's 3.35 TB/s, the kernel's ms a step (CUDA events over `steps`
chained steps, after a warm-up step) and its share of the bound, the grid
syncs a step and µs a phase, the grid and the resident blocks an SM from
the occupancy query; then one JSON line of the same numbers. Exits 1
when a rung's kernel and plain version differ by more than TOL. It runs on
the card only: a time taken on the CPU would not be the card's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels import chain_bisect as cb
from ..runtime.device import as_device
from .prof_decode_chain import H, M, PEAK_BYTES_S, ROWS, _chain_ms, make_inputs

S_CROSS = 12  # text rows of the cross K/V (the script's S_CROSS)
# of max|y| (and max|kn|, max|vn|): the plain version's arithmetic in another
# summation order, as for #11
TOL = 1e-2


def make_extra_operands(extras, layers: int, window: int, device, seed: int = 1) -> dict:
    """Seeded random operands of `extras`: offset, ln (scale near 1, bias
    near 0), cross K/V and caches of unit scale; finite, and not zeros,
    which draw less power on the card."""
    ex = cb.parse_extras(extras)
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    ops = {}
    if "smem" in ex:
        ops["offset"] = window // 2
    if "ln" in ex:
        ops["ln"] = torch.stack([1 + 0.1 * torch.randn((layers, H), generator=g, device=device),
                                 0.1 * torch.randn((layers, H), generator=g, device=device)],
                                dim=1).repeat(1, 4, 1).to(torch.bfloat16).contiguous()
    if "cross" in ex:
        ops["ck"], ops["cv"] = randn(layers, cb.B, S_CROSS, H), randn(layers, cb.B, S_CROSS, H)
    if "hbm" in ex:
        ops["kc"], ops["vc"] = randn(layers, cb.B, window, H), randn(layers, cb.B, window, H)
    return ops


def step_bytes(extras, layers: int, rows: int, window: int) -> int:
    """Bytes one step must move, each input read once and each output written
    once: w, s, x, y; the rows of ln, cross K/V and caches that it reads, the
    kn/vn it writes."""
    ex = cb.parse_extras(extras)
    n = layers * cb.CPL
    nbytes = n * H * H + 2 * n * H + 2 * 2 * rows * H
    if "ln" in ex:
        nbytes += 2 * layers * 2 * H  # scale and bias rows
    if "cross" in ex:
        nbytes += 2 * 2 * layers * cb.B * H  # row 0 of each b, K and V
    if "outs" in ex:
        nbytes += 2 * 2 * layers * cb.B * H
    if "dma" in ex:
        nbytes += 2 * 2 * layers * cb.B * window * H
    return nbytes


def rel_errors(got, ref) -> dict:
    """max|got - ref| / max|ref| of y (and kn, vn)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = {}
    for name, a, b in zip(("y", "kn", "vn"), got, ref):
        out[name] = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
    return out


def run_rung(extras, layers: int = 48, steps: int = 50, chunk: int = 512, window: int = 512, device=None,
             rows: int = M) -> dict:
    """One rung at `rows` rows on the card: numerics against the plain
    version, bytes and bound, ms a step and its share of the bound, syncs a
    step and µs a phase, the launch plan."""
    device = as_device(device)
    if device.type != "cuda":
        raise RuntimeError("the chain-bisect probe times the card and has no CPU run")
    spec = ",".join(e for e in cb.EXTRAS if e in cb.parse_extras(extras))
    w, s, x = make_inputs(layers, device)
    x = x[:rows].contiguous()
    ops = make_extra_operands(spec, layers, window, device)
    got = cb.chain_bisect(w, s, x, spec, chunk=chunk, **ops)
    ref = cb.chain_bisect_plain(w, s, x, spec, chunk=chunk, **ops)
    errs = rel_errors(got, ref)
    y = got[0] if isinstance(got, tuple) else got
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (got if isinstance(got, tuple) else (got,)))

    def step(v):
        out = cb.chain_bisect(w, s, v, spec, chunk=chunk, **ops)
        return out[0] if isinstance(out, tuple) else out

    nbytes = step_bytes(spec, layers, rows, window)
    bound = nbytes / PEAK_BYTES_S * 1e3
    ms = _chain_ms(step, x, steps)
    p = cb.plan(rows, H, spec)
    syncs = p["syncs_per_layer"] * layers
    return dict(extras=spec, layers=layers, steps=steps, rows=rows, hidden=H, chunk=chunk, window=window,
                rel_err=max(errs.values()), rel_errs=errs, finite=finite, y_abs_max=y.float().abs().max().item(),
                bytes=nbytes, bound_ms=bound, ms=ms, bound_share=bound / ms, syncs_per_step=syncs,
                us_per_phase=ms * 1e3 / syncs, **p)


def run(extras: str = "", ladder: bool = False, layers: int = 48, steps: int = 50, chunk: int = 512,
        window: int = 512, device=None) -> dict:
    """The script's run: `extras` alone, or its ladder, at each of ROWS."""
    todo = cb.LADDER if ladder else (extras,)
    return dict(rungs=[run_rung(spec, layers, steps, chunk, window, device, m) for m in ROWS for spec in todo])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extras", default="")
    ap.add_argument("--ladder", action="store_true", help="run the script's ladder in one process")
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--window", type=int, default=512)
    args = ap.parse_args(argv)
    ok = True
    for r in run(args.extras, args.ladder, args.layers, args.steps, args.chunk, args.window)["rungs"]:
        good = r["rel_err"] <= TOL and r["finite"]
        ok = ok and good
        print(f"M {r['rows']} extras={r['extras'] or '-'}: max|kernel - plain| {r['rel_err']:.3e} of max (tol "
              f"{TOL}, {'ok' if good else 'MISMATCH'}) | {r['bytes'] / 1e9:.4f} GB -> bound {r['bound_ms']:.4f} ms "
              f"at {PEAK_BYTES_S / 1e12:.2f} TB/s | {r['ms']:8.4f} ms/step ({r['bound_share']:.1%} of the bound; "
              f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s) | {r['syncs_per_step']} grid syncs a step, "
              f"{r['us_per_phase']:.2f} us a phase | grid {r['grid']}, {r['blocks_per_sm']} blocks/SM, "
              f"{r['smem_bytes']} B shared a block")
        print(json.dumps(r))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
