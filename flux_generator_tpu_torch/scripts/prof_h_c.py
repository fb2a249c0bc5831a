"""Kernels H (the per-row int8 quantizer) and C (the LSTM recurrence) at the
shapes a user's request gives them, for comparing two checkouts on one card.

    python3 flux_generator_tpu_torch/scripts/prof_h_c.py [--root DIR] [--label NAME] [--out FILE]

The package is imported from DIR (by default the checkout that holds this
file), so that the same measurement runs on another commit unpacked there
(`git archive`); to compare two, run parent, change, change, parent in one
call on one card. It uses only entry points that both the parent and this
tree have: `quantize_rows`, `lstm_recurrence`, `lstm` and `_project`.

- H at the seven activation shapes of a Flux-schnell 512² W8A8 "rows"
  request (`H_SHAPES`, with their launches a request): bit for bit against
  its plain version, queued behind a sleep kernel and by profiler device
  time, and the request-weighted sums; first the wrapper's host time a call
  at 1024×3072 (ten batches of 100 calls, sorted; the device never behind).
- C at d 1024 in bf16 at T 497 and 2497 (a 500-step and a 2500-step
  MusicGen request; 2 launches each) and at d 512 in f32: against its plain
  version (T 497 only), and queued in turns with its route (the input
  projection, then the kernel) and cuDNN's `nn.LSTM` (its weights compacted
  once).

Inputs are seeded random. It prints one JSON line, with the card's name and
power limit, and exits 1 when a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

# (M, K) of every activation a "rows" request quantizes, and its launches a request
H_SHAPES = ((1280, 3072, 152), (1280, 15360, 152), (1024, 3072, 232), (1024, 12288, 76),
            (256, 3072, 228), (256, 12288, 76), (256, 4096, 4))
# (label, d, T, dtype name) of C
C_CASES = (("d1024_T497_bf16", 1024, 497, "bfloat16"), ("d1024_T2497_bf16", 1024, 2497, "bfloat16"),
           ("d512_T497_f32", 512, 497, "float32"))
LSTM_TOL = {"bfloat16": 2e-3, "float32": 1e-4}


def _device_ms(fn, iters=10, warmup=3) -> float:
    """Mean device time of fn() under torch.profiler: its kernels' sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.device_time_total for ev in prof.events() if ev.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device time in three tries")


def measure_h(wm, queued_ms, dev) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    # the host's time first, before the profiler has run in this process
    x = torch.randn((1024, 3072), generator=g, device=dev).to(torch.bfloat16)
    for _ in range(20):
        wm.quantize_rows(x)
    torch.cuda.synchronize()
    host_us = []
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(100):
            wm.quantize_rows(x)
        host_us.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    cases, sums, equal = {}, dict(queued=0.0, device=0.0), True
    for m, k, per_request in H_SHAPES:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q, s = wm.quantize_rows(x)
        rq, rs = wm.quantize_rows_reference(x)
        same = bool(torch.equal(q, rq) and torch.equal(s, rs))
        equal &= same
        ms, dev_ms = queued_ms(lambda: wm.quantize_rows(x)), _device_ms(lambda: wm.quantize_rows(x))
        cases[f"{m}x{k}"] = dict(launches_per_request=per_request, equal_to_plain=same, queued_ms=ms,
                                 device_ms=dev_ms)
        sums["queued"] += per_request * ms
        sums["device"] += per_request * dev_ms
    return dict(cases=cases, request_sums_ms=sums, host_us_a_call=sorted(host_us), equal_to_plain=equal)


def measure_c(lk, queued_ms, dev) -> dict:
    import torch
    import torch.backends.cudnn.rnn as cudnn_rnn

    g = torch.Generator(device=dev).manual_seed(4321)
    cases, ok = {}, True
    for label, d, t, dtype_name in C_CASES:
        wd = getattr(torch, dtype_name)
        x = torch.randn((1, t, d), generator=g, device=dev)
        p = {"wx": torch.randn((d, 4 * d), generator=g, device=dev) / d ** 0.5,
             "wh": torch.randn((d, 4 * d), generator=g, device=dev) / d ** 0.5,
             "bias": torch.randn((4 * d,), generator=g, device=dev) * 0.1}
        xw, wh = lk._project(p, x)
        err = None
        if t < 1000:
            err = (lk.lstm_recurrence(xw, wh, torch.float32)
                   - lk.lstm_recurrence_plain(xw, wh, torch.float32)).abs().max().item()
            ok &= err <= LSTM_TOL[dtype_name]
        cudnn = torch.nn.LSTM(d, d, batch_first=True).to(dev, wd)
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(cudnn._flat_weights, 4, d, cudnn_rnn.get_cudnn_mode("LSTM"), d, 0, 1,
                                            True, False)
            x_in = x.to(wd)
            calls = {"kernel": lambda: lk.lstm_recurrence(xw, wh, torch.float32),
                     "route": lambda: lk.lstm(p, x), "cudnn": lambda: cudnn(x_in)}
            turns = {name: [] for name in calls}
            for name, fn in list(calls.items()) + list(calls.items())[::-1]:
                turns[name].append(queued_ms(fn, iters=5))
        cases[label] = dict(max_abs_err=err, queued_ms_in_turns=turns)
    return dict(cases=cases, within_tolerance=ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="checkout whose flux_generator_tpu_torch is measured")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from flux_generator_tpu_torch.ops.kernels import lstm as lk
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm
    from flux_generator_tpu_torch.runtime.device import as_device
    from flux_generator_tpu_torch.scripts.prof_flash_bwd import queued_ms

    dev = as_device(None)
    if dev.type != "cuda":
        raise SystemExit("prof_h_c times the CUDA kernels: it needs the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[dev.index or 0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    h = measure_h(wm, queued_ms, dev)
    c = measure_c(lk, queued_ms, dev)
    rec = dict(label=args.label, root=args.root, device=card, H=h, C=c, seconds=time.perf_counter() - t0)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if h["equal_to_plain"] and c["within_tolerance"] else 1


if __name__ == "__main__":
    sys.exit(main())
