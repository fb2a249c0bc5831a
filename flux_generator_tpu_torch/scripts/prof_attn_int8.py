"""Where does int8 attention lose its time on the card?

    python -m flux_generator_tpu_torch.scripts.prof_attn_int8 [--steps 64] [--skip-flash] [--skip-dots] [--cpu]

The port's counterpart of scripts/prof_attn_int8.py. Kernel A's int8 tiers
are slower than its bf16 tier; two causes are measured apart:
  1. the int8 matrix unit itself: the bare-dot probe (#13, kernel
     csrc/bare_dot.cu), `steps` blocked (1024, 128)·(128, 1024) dots in one
     launch, bf16 against int8 inputs;
  2. quantizing inside the kernel: the same dots with bf16 inputs quantized
     per a row and b column in every output tile ("int8_quant_inside").
Then kernel A in its three tiers ("" bf16, "qk", "full" in groups of 1024
keys) through `flash_attention_streamed` at the 2048² Flux geometry (B 1,
L 16640, H 24, D 128, RoPE tables of 16640 positions).

Inputs are seeded random. Times come from CUDA events: the median of five
calls after one warm-up. Each bare dot is also held to its plain version
(the int8 modes bit for bit); the run exits 1 when one disagrees. It runs on
the card only, where a time is the card's; `--cpu` instead runs the plain
versions of the bare dots at BM = BN = 256, 2 steps, as the JAX script's
`--interpret` does, and prints no time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from ..ops.kernels import bare_dot as bd
from ..ops.kernels import flash_attention as fa
from ..ops.rope import rope_cos_sin
from ..runtime.device import as_device

BM, K, BN = 1024, 128, 1024
FLASH = dict(b=1, l=16640, h=24, d=128, blk_k=1024)
TIERS = ("", "qk", "full")


def dot_inputs(mode: str, steps: int, device, bm: int = BM, bn: int = BN, seed: int = 0):
    """a (steps·BM, K), b (K, steps·BN): int8 levels in [-127, 127] for
    "int8", else standard normal in bf16."""
    g = torch.Generator(device=device).manual_seed(seed)
    if mode == "int8":
        return (torch.randint(-127, 128, (steps * bm, K), generator=g, device=device, dtype=torch.int8),
                torch.randint(-127, 128, (K, steps * bn), generator=g, device=device, dtype=torch.int8))
    return (torch.randn((steps * bm, K), generator=g, device=device).to(torch.bfloat16),
            torch.randn((K, steps * bn), generator=g, device=device).to(torch.bfloat16))


def flash_inputs(device, seed: int = 0):
    """q, k, v (1, 16640, 24, 128) bf16 standard normal and RoPE tables of
    positions 0..16639, as the JAX script's `flash_modes`."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, l, h, d = FLASH["b"], FLASH["l"], FLASH["h"], FLASH["d"]
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    cos, sin = rope_cos_sin(torch.arange(l, device=device)[None], d)
    return q, k, v, cos.to(torch.bfloat16), sin.to(torch.bfloat16)


def median_ms(fn, reps: int = 5) -> float:
    """Median device ms of fn() over `reps` calls after one warm-up, each
    between two CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(steps: int = 64, dots: bool = True, flash: bool = True, device=None) -> dict:
    """The probe on the card → {"dots": {mode: ...}, "flash": {tier: ...}}."""
    device = as_device(device)
    if device.type != "cuda":
        raise RuntimeError("the int8 attention probe times the card; --cpu runs the plain versions")
    out = {"device": torch.cuda.get_device_name(device), "dots": {}, "flash": {}}
    if dots:
        tflop = 2 * BM * K * BN * steps / 1e12
        for mode in bd.MODES:
            a, b = dot_inputs(mode, steps, device)
            got = bd.bare_dot(a, b, mode)
            ref = bd.bare_dot_reference(a, b, mode)
            err = (got.float() - ref.float()).abs().max().item()
            # bf16 sums in another order may round one bf16 step apart; the
            # int8 modes are exact integer sums with the same f32 epilogue
            tol = 0.0 if mode != "bf16" else 2.0 ** -8 * ref.float().abs().max().item()
            ms = median_ms(lambda: bd.bare_dot(a, b, mode))
            out["dots"][mode] = dict(steps=steps, ms=ms, tflops=tflop / (ms / 1e3), max_abs_err=err, tol=tol,
                                     ok=err <= tol)
            print(f"bare dot {mode:18s} {ms:8.4f} ms  ({tflop / (ms / 1e3):6.1f} TFLOP/s-eff, "
                  f"{tflop:.4f} TF) | max|kernel - plain| {err:.3e} (tol {tol:.3e})", flush=True)
    if flash:
        q, k, v, cos, sin = flash_inputs(device)
        l, h, d = FLASH["l"], FLASH["h"], FLASH["d"]
        tf = 4 * l * l * d * h / 1e12
        for tier in TIERS:
            ms = median_ms(lambda: fa.flash_attention_streamed(q, k, v, cos, sin, int8=tier,
                                                               blk_k=FLASH["blk_k"]))
            out["flash"][tier or "bf16"] = dict(ms=ms, tflops=tf / (ms / 1e3))
            print(f"streamed flash {l}tok mode={tier or 'bf16':5s} {ms:8.2f} ms "
                  f"({tf / (ms / 1e3):6.1f} TFLOP/s-eff)", flush=True)
    return out


def run_cpu() -> dict:
    """The plain bare dots at BM = BN = 256, 2 steps, on the CPU."""
    out = {}
    for mode in bd.MODES:
        a, b = dot_inputs(mode, 2, torch.device("cpu"), bm=256, bn=256)
        y = bd.bare_dot(a, b, mode, bm=256, bn=256)
        out[mode] = dict(shape=list(y.shape), finite=bool(torch.isfinite(y.float()).all()),
                         sum=float(y.float().sum()))
        print(f"bare dot {mode:18s} (plain version, CPU) {tuple(y.shape)} sum {out[mode]['sum']:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--skip-flash", action="store_true")
    ap.add_argument("--skip-dots", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run the plain bare dots on the CPU, untimed")
    args = ap.parse_args(argv)
    if args.cpu:
        print(json.dumps(run_cpu()))
        return 0
    r = run(args.steps, dots=not args.skip_dots, flash=not args.skip_flash)
    print(json.dumps(r))
    return 0 if all(x["ok"] for x in r["dots"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
