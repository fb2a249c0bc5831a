"""Time the decode-chain probe (kernel #11) on the card.

    python -m flux_generator_tpu_torch.scripts.prof_decode_chain [--layers 48] [--steps 50]

The port's counterpart of scripts/prof_pallas_chain.py: kernel D's weight
stream — L × 14 int8 (1536, 1536) chunks with bf16 scales — with attention
as identity, on 8 rows (the script's 2 live CFG rows, padded), from seeded
random weights.
It prints the kernel's numerics against its plain version, the weight bytes
and their floor at the card's 3.35 TB/s, the kernel's ms a step (CUDA events
over `steps` chained steps) and the plain chain's ms a step on the card,
which stands where the JAX script timed its XLA formulation; then one JSON
line of the same numbers. Exits 1 when the kernel and the plain version
differ by more than TOL of max|y|. It runs on the card only: a time taken on
the CPU would not be the card's.
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


def run(layers: int = 48, steps: int = 50, device=None) -> dict:
    device = as_device(device)
    if device.type != "cuda":
        raise RuntimeError("the decode-chain probe times the card and has no CPU run")
    w, s, x = make_inputs(layers, device)
    y = dc.decode_chain(w, s, x)
    ref = dc.decode_chain_plain(w, s, x)
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # each input read once, y written once
    nbytes = w.numel() + 2 * s.numel() + 2 * 2 * x.numel()
    return dict(layers=layers, steps=steps, rows=M, hidden=H, max_abs_err=err, rel_err=err / scale,
                finite=bool(torch.isfinite(y).all()), weight_gb=w.numel() / 1e9, bytes=nbytes,
                bound_ms=nbytes / PEAK_BYTES_S * 1e3,
                ms=_chain_ms(lambda v: dc.decode_chain(w, s, v), x, steps),
                plain_ms=_chain_ms(lambda v: dc.decode_chain_plain(w, s, v), x, max(1, min(steps, 5))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    r = run(args.layers, args.steps)
    print(f"numerics: max|kernel - plain| = {r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}, tol {TOL}), "
          f"finite {r['finite']}")
    print(f"weights {r['weight_gb']:.3f} GB int8 ({r['bytes'] / 1e9:.4f} GB with scales and rows) "
          f"-> floor {r['bound_ms']:.4f} ms at {PEAK_BYTES_S / 1e12:.2f} TB/s")
    print(f"CUDA chain kernel : {r['ms']:8.4f} ms/step at {r['rows']} rows ({r['bytes'] / r['ms'] / 1e6:.1f} GB/s)")
    print(f"plain chain       : {r['plain_ms']:8.4f} ms/step")
    print(json.dumps(r))
    return 0 if r["rel_err"] <= TOL and r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
