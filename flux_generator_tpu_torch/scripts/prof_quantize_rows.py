"""Which geometry of kernel H, the per-row int8 quantizer, is fastest?

    python -m flux_generator_tpu_torch.scripts.prof_quantize_rows

Kernel H (ops/kernels/w8a8_matmul.py, `quantize_rows`) takes its launch from
`quantize_geometry`: the 16-byte chunks a thread takes (1, 2, 4 or 8; the
threads a row follow). This probe runs, at each activation shape of a
Flux-schnell 512² W8A8 "rows" request (chip_smoke.py's G_SHAPES), the
chosen geometry and every other chunk count, each held bit for bit to the
plain version (the run exits 1 when one is not), and times them in turns:
each setting's mean over 20 calls queued behind a sleep kernel, the
settings in order and then in reverse. Inputs are seeded random. It runs on
the card only and prints one JSON line a shape, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops.kernels import w8a8_matmul as wm
from ..runtime.device import as_device
from .prof_flash_bwd import queued_ms
from .prof_h_c import H_SHAPES as REQUEST_SHAPES


def settings(m: int, k: int, sms: int) -> dict:
    """{name: geometry}: the chosen one and every other chunk count (1, 2,
    4, 8) that covers a row within a block (H_MAX_THREADS threads)."""
    chosen = wm.quantize_geometry(m, k, sms)
    out = {"chosen": chosen}
    for c in (1, 2, 4, 8):
        tpr = wm._cdiv(wm._cdiv(k // 8, c), 32) * 32
        if c == chosen.chunks or tpr > wm.H_MAX_THREADS:
            continue
        rows = max(1, wm.H_BLOCK_THREADS // tpr)
        out[f"chunks {c}"] = wm.HGeometry("registers", c, tpr, rows, wm._cdiv(m, rows))
    return out


def run(shapes=REQUEST_SHAPES, device=None) -> list:
    dev = as_device(device)
    if dev.type != "cuda":
        raise RuntimeError("prof_quantize_rows times the CUDA kernel: it needs the card")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[dev.index or 0]
    g = torch.Generator(device=dev).manual_seed(3)
    out = []
    for m, k, per_request in shapes:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        want_q, want_s = wm.quantize_rows_reference(x)
        geos = settings(m, k, sms)
        calls = {name: (lambda geo=geo: wm._launch_h(x, geo)) for name, geo in geos.items()}
        equal = {}
        for name, call in calls.items():
            q, s = call()
            equal[name] = bool(torch.equal(q, want_q) and torch.equal(s, want_s))
        order = list(calls.items())
        times = {name: [] for name in calls}
        for name, call in order + order[::-1]:
            times[name].append(queued_ms(call))
        rec = dict(shape=[m, k], launches_per_request=per_request, sms=sms,
                   geometries={name: geo._asdict() for name, geo in geos.items()},
                   equal_to_plain=equal, ms=times, device=card)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    records = run()
    bad = [(r["shape"], name) for r in records for name, ok in r["equal_to_plain"].items() if not ok]
    if bad:
        print(f"prof_quantize_rows: geometries that differ from the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
