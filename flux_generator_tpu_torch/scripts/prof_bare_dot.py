"""The bare-dot probe #13 in its three modes at the probe's shape, for
comparing two checkouts on one card.

    python3 flux_generator_tpu_torch/scripts/prof_bare_dot.py [--root DIR] [--label NAME] [--out FILE] [--turns N]
        [--steps S]

The package is imported from DIR (by default the checkout that holds this
file), so that the same measurement runs on another commit unpacked there
(`git archive`); to compare two, run parent, change, change, parent in one
call on one card. It uses only `bare_dot`, `bare_dot_reference` and `MODES`,
which the parent has too.

At 64 steps (or S) of (1024, 128)·(128, 1024), on seeded random inputs (int8
levels in [-127, 127] for "int8", standard normal bf16 else): each mode
against its plain version (the int8 modes bit for bit, "bf16" within one
bf16 step of max|out|), then the three modes, `torch.bmm` on the bf16
blocks and a zero fill of out's size (its 134 MB alone) timed in turns: N
rounds, each in order and then in reverse, every reading the mean of 20
calls between CUDA events, queued behind a sleep kernel. The bound of a mode
is its bytes (a and b read once, out written once) at 3.35 TB/s. It prints
one JSON line, with the card's name and power limit, and exits 1 when a mode
disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

BM, K, BN = 1024, 128, 1024
PEAK_BYTES_S = 3.35e12


def time_ms_queued(torch, fn, iters: int = 20) -> float:
    """Mean device ms of fn() over `iters` calls between CUDA events, enqueued
    behind a sleep kernel so that the host's cost between calls does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="append the JSON line to this file too")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from flux_generator_tpu_torch.ops.kernels import bare_dot as bd

    if not torch.cuda.is_available():
        raise RuntimeError("prof_bare_dot times the card: no CUDA device")
    dev = torch.device("cuda")
    steps = args.steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(13)
    inputs = {}
    for mode in bd.MODES:
        if mode == "int8":
            inputs[mode] = (torch.randint(-127, 128, (steps * BM, K), generator=g, device=dev, dtype=torch.int8),
                            torch.randint(-127, 128, (K, steps * BN), generator=g, device=dev, dtype=torch.int8))
        else:
            inputs[mode] = (torch.randn((steps * BM, K), generator=g, device=dev).to(torch.bfloat16),
                            torch.randn((K, steps * BN), generator=g, device=dev).to(torch.bfloat16))
    rec = {"label": args.label, "root": args.root, "card": smi, "steps": steps, "modes": {}}
    ok = True
    for mode, (a, b) in inputs.items():
        got = bd.bare_dot(a, b, mode)
        ref = bd.bare_dot_reference(a, b, mode)
        err = (got.float() - ref.float()).abs().max().item()
        tol = 0.0 if mode != "bf16" else 2.0 ** -8 * ref.float().abs().max().item()
        ok = ok and err <= tol
        nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() + 2 * steps * BM * BN
        rec["modes"][mode] = dict(max_abs_err=err, tol=tol, bound_ms=nbytes / PEAK_BYTES_S * 1e3)
        del got, ref
    out = torch.empty((steps * BM, BN), dtype=torch.bfloat16, device=dev)
    a3 = inputs["bf16"][0].view(steps, BM, K)
    b3 = inputs["bf16"][1].view(K, steps, BN).permute(1, 0, 2)
    fns = {mode: (lambda m=mode: bd.bare_dot(*inputs[m], m)) for mode in bd.MODES}
    fns.update({"bmm": lambda: torch.bmm(a3, b3), "zero": lambda: out.zero_()})
    turns = {name: [] for name in fns}
    items = list(fns.items())
    for _ in range(args.turns):
        for name, fn in items + items[::-1]:
            turns[name].append(time_ms_queued(torch, fn))
    for name, times in turns.items():
        entry = rec["modes"].setdefault(name, {})
        entry.update(ms_in_turns=times, ms=statistics.mean(times))
        if "bound_ms" in entry:
            entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    if hasattr(bd, "plan"):
        rec["plans"] = {m: bd.plan(m, K, BM, BN, steps) for m in ("int8", "int8_quant_inside")}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
