"""Does splitting a short last wave pay in kernels E and F?

    python -m flux_generator_tpu_torch.scripts.prof_flash_bwd [--min-parts 2 5]

Kernels E (dQ) and F (dK, dV) of ops/kernels/flash_attention_bwd.py run one
block an SM, a block per 128 rows of one (batch, head). When the units of
the last wave fill few SMs, the wrapper runs each of them in parts of its
tile loop (`split_plan`), but only in MIN_PARTS parts or more. This probe
times the pair as the backward runs it (F launched as E's programmatic
dependent), E alone and F alone, at the shapes of chip_smoke.py's
kernels-train (L 1536, 1280 and 1000 with 24 heads of 128; D 64 with B 2,
L 1024, 10 heads), with each `--min-parts` value given and with every unit
whole, in turns: each setting's mean over 20 calls queued behind a sleep
kernel, the settings in order and then in reverse. Every setting's
gradients are held to the whole setting's (2e-2 of max|ref|); the run
exits 1 when one disagrees. Inputs are seeded random. It runs on the card
only and prints one JSON line a shape, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops.kernels import flash_attention as fa
from ..ops.kernels import flash_attention_bwd as fb
from ..runtime.device import as_device

SHAPES = ((1, 1536, 24, 128), (1, 1280, 24, 128), (1, 1000, 24, 128), (2, 1024, 10, 64))
REL_TOL = 2e-2


def plans(shape, sms: int, min_parts) -> tuple:
    """E's and F's split plans at `shape` ((B, L, H, D)) on `sms` SMs with
    split units of `min_parts` parts or more; None: every unit whole."""
    b, l, h, _ = shape
    units = -(-l // fb.ROWS) * b * h
    return tuple((units, 1) if min_parts is None else fb.split_plan(units, -(-l // tile), sms, min_parts)
                 for tile in (fb.KEY_TILE, fb.QUERY_TILE))


def _calls(args, plan_e, plan_f):
    """The pair, E alone and F alone under the given plans."""
    shape, dev = args[0].shape, args[0].device

    def pair():
        (pe, te), (pf, tf) = fb._split_buffers(shape, dev, [(plan_e, 1), (plan_f, 2)])
        dq = fb._launch_dq(*args, plan_e, pe, te)
        return (dq, *fb._launch_dkv(*args, plan_f, pf, tf, after_dq=True))

    def dq():
        ((p, t),) = fb._split_buffers(shape, dev, [(plan_e, 1)])
        return fb._launch_dq(*args, plan_e, p, t)

    def dkv():
        ((p, t),) = fb._split_buffers(shape, dev, [(plan_f, 2)])
        return fb._launch_dkv(*args, plan_f, p, t, after_dq=False)

    return {"pair": pair, "dq": dq, "dkv": dkv}


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls between CUDA events,
    enqueued behind a sleep kernel so that the host's cost does not show."""
    for _ in range(warmup):
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


def run(min_parts=(2, fb.MIN_PARTS), device=None) -> list:
    dev = as_device(device)
    if dev.type != "cuda":
        raise RuntimeError("prof_flash_bwd times the CUDA kernels: it needs the card")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[dev.index or 0]
    settings = {f"parts>={m}": m for m in min_parts}
    settings["whole"] = None
    g = torch.Generator(device=dev).manual_seed(9)
    out = []
    for shape in SHAPES:
        b, l, h, d = shape
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_sm90(q, k, v)
        dvec = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, l).contiguous()
        args = (q, k, v, do, lse, dvec, d ** -0.5)
        planned = {name: plans(shape, sms, m) for name, m in settings.items()}
        calls = {name: _calls(args, *p) for name, p in planned.items()}
        want = calls["whole"]["pair"]()
        errs = {}
        for name, c in calls.items():
            got = c["pair"]()
            errs[name] = max(((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
                             for x, y in zip(got, want))
        rec = dict(shape=shape, sms=sms, plans=planned, max_rel_diff=errs, device=card)
        for what in ("pair", "dq", "dkv"):
            order = list(calls.items())
            times = {name: [] for name in calls}
            for name, c in order + order[::-1]:
                times[name].append(queued_ms(c[what]))
            rec[f"{what}_ms"] = times
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-parts", type=int, nargs="+", default=[2, fb.MIN_PARTS],
                    help="the fewest parts of a split unit, one setting each (besides every unit whole)")
    args = ap.parse_args(argv)
    records = run(tuple(args.min_parts))
    bad = [(r["shape"], r["max_rel_diff"]) for r in records if max(r["max_rel_diff"].values()) > REL_TOL]
    if bad:
        print(f"prof_flash_bwd: settings disagree with the whole units: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
