"""Kernel D (the fused MusicGen decode step) and its probes #11 (decode chain)
and #12 (chain bisect) at the shapes a user's request and the probes give
them, for comparing two checkouts on one card.

    python3 flux_generator_tpu_torch/scripts/prof_decode_step.py [--root DIR] [--label NAME] [--out FILE]
        [--turns 2]

The package is imported from DIR (by default the checkout that holds this
file), so that the same measurement runs on another commit unpacked there
(`git archive`); to compare two, run parent, change, change, parent in one
call on one card. It uses only entry points that both the parent and this
tree have: `fused_decode_step`, `decode_chain`, `chain_bisect` and the
probes' seeded inputs.

- D at MusicGen-medium (48 layers, H 1536, 24 heads) at the shapes of
  `chip_smoke.py`'s kernels-musicgen and kernels-musicgen-f8 phases
  (`D_CASES`): its launches, a digest of its output bytes (y and the new
  cache rows of every layer), and its ms a call (CUDA events over ITERS
  calls, `turns` times, after a warm-up).
- #11 at 8 and 2 rows and #12's eight cumulative rungs at 8 and 2 rows, on
  the probes' own inputs (48 layers, W 512, chunk 512): ms a step the same
  way, in turns with #11 (#11, rung, rung, #11).

Inputs are seeded random, the same in every checkout. It prints one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import threading
import time

# (label, weights, rows, window, offset, cache: bf16 or e4m3, text rows masked at 5 in odd rows)
D_CASES = (("int8_B2_W8_off5", "int8", 2, 8, 5, "bf16", False),
           ("int8_B2_W500_off250", "int8", 2, 500, 250, "bf16", False),
           ("int8_B2_W500_off499", "int8", 2, 500, 499, "bf16", True),
           ("int8_B8_W2048_off1900", "int8", 8, 2048, 1900, "bf16", True),
           ("bf16_B2_W500_off499", "bf16", 2, 500, 499, "bf16", True),
           ("bf16_B8_W2048_off100", "bf16", 8, 2048, 100, "bf16", True),
           ("f8_int8_B2_W2500_off2499", "int8", 2, 2500, 2499, "e4m3", True),
           ("f8_int8_B8_W2048_off1900", "int8", 8, 2048, 1900, "e4m3", True),
           ("f8_bf16_B2_W500_off250", "bf16", 2, 500, 250, "e4m3", True))
LAYERS, HIDDEN, HEADS, TEXT = 48, 1536, 24, 16
ITERS = 20


def _ms(torch, fn, iters: int) -> float:
    """Mean ms of fn() over `iters` calls between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _digest(torch, *tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure_d(torch, ds, dev, turns: int, iters: int) -> list:
    g = torch.Generator(device=dev).manual_seed(4321)
    n = LAYERS * 14
    ln = torch.stack([1 + 0.1 * torch.randn((LAYERS, HIDDEN), generator=g, device=dev),
                      0.1 * torch.randn((LAYERS, HIDDEN), generator=g, device=dev)], dim=1).repeat(1, 4, 1)
    ln = ln.to(torch.bfloat16).contiguous()
    packs = {"int8": {"w": torch.randint(-127, 128, (n, HIDDEN, HIDDEN), generator=g, device=dev, dtype=torch.int8),
                      "s": ((0.5 + torch.rand((n, 1, HIDDEN), generator=g, device=dev)) / (127 * HIDDEN ** 0.5)
                            ).to(torch.bfloat16), "ln": ln},
             "bf16": {"w": (torch.randn((n, HIDDEN, HIDDEN), generator=g, device=dev) / HIDDEN ** 0.5
                            ).to(torch.bfloat16),
                      "s": torch.ones((n, 1, HIDDEN), dtype=torch.bfloat16, device=dev), "ln": ln}}
    cases = []
    for label, wkey, b, w, offset, cache, masked in D_CASES:
        packed = packs[wkey]
        x = torch.randn((b, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        ck = torch.randn((LAYERS, b, TEXT, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        cv = torch.randn((LAYERS, b, TEXT, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn((LAYERS, b, w, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((LAYERS, b, w, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        if cache == "e4m3":
            kc, vc = kc.to(torch.float8_e4m3fn), vc.to(torch.float8_e4m3fn)
        cl = torch.full((b,), TEXT, dtype=torch.int32, device=dev)
        if masked:
            cl[1::2] = 5
        before = ds.launches
        y, kc, vc = ds.fused_decode_step(packed, x, ck, cv, offset, kc, vc, cl, n_heads=HEADS)
        torch.cuda.synchronize()
        launches = ds.launches - before
        digest = _digest(torch, y, kc[:, :, offset], vc[:, :, offset])
        step = lambda: ds.fused_decode_step(packed, x, ck, cv, offset, kc, vc, cl, n_heads=HEADS)  # noqa: E731
        ms = [_ms(torch, step, iters) for _ in range(turns)]
        cases.append(dict(case=label, launches=launches, digest=digest, ms=ms))
        del x, ck, cv, kc, vc, y
    return cases


def measure_probes(torch, dc, cb, probe, chain_probe, dev, turns: int, iters: int) -> dict:
    w, s, x8 = chain_probe.make_inputs(LAYERS, dev)
    every = probe.make_extra_operands(cb.RUNGS[-1], LAYERS, 512, dev)
    out = {}
    for m in (8, 2):
        x = x8[:m].contiguous()
        chain = lambda: dc.decode_chain(w, s, x)  # noqa: E731
        rec = {"chain_ms": [], "rungs": {}}
        for spec in cb.RUNGS:
            ex = cb.parse_extras(spec)
            ops = {k: v for k, v in every.items() if cb.OPERAND_EXTRA[k] in ex}
            rung = lambda: cb.chain_bisect(w, s, x, spec, **ops)  # noqa: E731
            t = [_ms(torch, f, iters) for f in (chain, rung, rung, chain) * turns]
            rec["chain_ms"] += t[0::4] + t[3::4]
            rec["rungs"][spec or "none"] = t[1::4] + t[2::4]
        out[str(m)] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="checkout whose flux_generator_tpu_torch is measured")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from flux_generator_tpu_torch.ops.kernels import _build
    from flux_generator_tpu_torch.ops.kernels import chain_bisect as cb
    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.runtime.device import as_device
    from flux_generator_tpu_torch.scripts import prof_chain_bisect as probe
    from flux_generator_tpu_torch.scripts import prof_decode_chain as chain_probe

    dev = as_device(None)
    if dev.type != "cuda":
        raise SystemExit("prof_decode_step times the CUDA kernels: it needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[dev.index or 0]
    t0 = time.perf_counter()
    errors = []

    def build(name, mod):
        try:
            _build.load(name, mod._SIGNATURES)
        except Exception as e:  # reported after the join, then raised
            errors.append(e)

    threads = [threading.Thread(target=build, args=a) for a in
               (("decode_step", ds), ("decode_chain", dc), ("chain_bisect", cb))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    built = time.perf_counter() - t0
    rec = dict(label=args.label, root=args.root, device=card, build_s=built, d_info=ds.kernel_info(),
               d=measure_d(torch, ds, dev, args.turns, ITERS),
               probes=measure_probes(torch, dc, cb, probe, chain_probe, dev, args.turns, ITERS),
               seconds=time.perf_counter() - t0)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
