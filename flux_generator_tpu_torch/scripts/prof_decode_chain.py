"""Time the decode-chain probe (kernel #11) on the card.

    python -m flux_generator_tpu_torch.scripts.prof_decode_chain [--layers 48] [--steps 50]

The port's counterpart of scripts/prof_pallas_chain.py: kernel D's weight
stream — L × 14 int8 (1536, 1536) chunks with bf16 scales — on D's own
machinery (its schedule, TMA weight ring, tensor-core products and folds),
with attention as identity, from seeded random weights, at 8 rows (four
coalesced CFG requests) and at 2 (one request's two CFG rows).
For each it prints the kernel's numerics against its plain version, the
bytes the step must move and their bound at the card's 3.35 TB/s, the
kernel's ms a step (CUDA events over `steps` chained steps) and its share
of the bound, the grid syncs a step, µs a phase (ms over the phases), and
one launch's phase split from block 0's device clock; then the plain
chain's ms a step on the card at 8 rows, which stands where the JAX script
timed its XLA formulation, and one JSON line of the same numbers. Exits 1
when the kernel and the plain version differ by more than TOL of max|y|. It
runs on the card only: a time taken on the CPU would not be the card's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.kernels import decode_chain as dc
from ..ops.kernels.decode_step import CPL
from ..runtime.device import as_device

H, M = 1536, 8
ROWS = (M, 2)  # four coalesced CFG requests, and one request's two CFG rows
PEAK_BYTES_S = 3.35e12  # HBM of one H100 SXM (NVIDIA data sheet)
# of max|y|: the plain version's arithmetic in another summation order, as
# for kernel D
TOL = 1e-2


def make_inputs(layers: int, device, seed: int = 0):
    """w (L·14, H, H) int8, s (L·14, 1, H) bf16 with |w·s| ~ 0.6/√H (unit-scale
    outputs), x (M, H) bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = layers * CPL
    w = torch.randint(-127, 128, (n, H, H), generator=g, device=device, dtype=torch.int8)
    s = ((0.5 + torch.rand((n, 1, H), generator=g, device=device)) / (127 * H ** 0.5)).to(torch.bfloat16)
    x = torch.randn((M, H), generator=g, device=device).to(torch.bfloat16)
    return w, s, x


def _chain_ms(step, x, steps: int) -> float:
    """Device ms a step over `steps` chained steps x → step(x), after one
    warm-up step, by CUDA events."""
    y = step(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        y = step(y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def step_bytes(layers: int, rows: int) -> int:
    """Bytes a step must move: w and s read once, x read, y written."""
    n = layers * CPL
    return n * H * H + 2 * n * H + 2 * 2 * rows * H


def run(layers: int = 48, steps: int = 50, device=None) -> dict:
    device = as_device(device)
    if device.type != "cuda":
        raise RuntimeError("the decode-chain probe times the card and has no CPU run")
    w, s, x8 = make_inputs(layers, device)
    info = dc.kernel_info()
    syncs = info["syncs_per_layer"] * layers
    cases = []
    for m in ROWS:
        x = x8[:m].contiguous()
        y = dc.decode_chain(w, s, x)
        ref = dc.decode_chain_plain(w, s, x)
        err = (y.float() - ref.float()).abs().max().item()
        nbytes = step_bytes(layers, m)
        bound = nbytes / PEAK_BYTES_S * 1e3
        ms = _chain_ms(lambda v: dc.decode_chain(w, s, v), x, steps)
        cases.append(dict(rows=m, max_abs_err=err, rel_err=err / ref.float().abs().max().item(),
                          finite=bool(torch.isfinite(y).all()), bytes=nbytes, bound_ms=bound, ms=ms,
                          bound_share=bound / ms, us_per_phase=ms * 1e3 / syncs,
                          phase_us=dc.phase_times(w, s, x)))
    plain_ms = _chain_ms(lambda v: dc.decode_chain_plain(w, s, v), x8, max(1, min(steps, 5)))
    return dict(layers=layers, steps=steps, hidden=H, weight_gb=w.numel() / 1e9, syncs_per_step=syncs,
                kernel=info, cases=cases, rel_err=max(c["rel_err"] for c in cases),
                finite=all(c["finite"] for c in cases), plain_ms=plain_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    r = run(args.layers, args.steps)
    print(f"weights {r['weight_gb']:.3f} GB int8; {r['syncs_per_step']} grid syncs a step; kernel {r['kernel']}")
    for c in r["cases"]:
        print(f"M {c['rows']}: max|kernel - plain| {c['max_abs_err']:.3e} (rel {c['rel_err']:.3e}, tol {TOL}), "
              f"finite {c['finite']} | {c['ms']:.4f} ms/step, bound {c['bound_ms']:.4f} ms at "
              f"{PEAK_BYTES_S / 1e12:.2f} TB/s ({c['bound_share']:.1%} of it; {c['bytes'] / c['ms'] / 1e6:.1f} GB/s) "
              f"| {c['us_per_phase']:.2f} us a phase | split, us a step: "
              + ", ".join(f"{k} {v:.1f}" for k, v in c["phase_us"].items()))
    print(f"plain chain at M {M}: {r['plain_ms']:8.4f} ms/step")
    print(json.dumps(r))
    return 0 if r["rel_err"] <= TOL and r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
