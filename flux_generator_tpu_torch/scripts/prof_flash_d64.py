"""Kernel A's bf16 forward at head dim 64 (the SD and SDXL UNet
self-attention, no RoPE), in turns with SDPA's forward, for one checkout or
for comparing two on one card.

    python3 flux_generator_tpu_torch/scripts/prof_flash_d64.py [--root DIR] [--label NAME] [--out FILE]
        [--geometries] [--shapes NAME,...] [--requests N]

The package is imported from DIR (by default the checkout that holds this
file), so that the same measurement runs on another commit unpacked there
(`git archive`); to compare two, run parent, change, change, parent in one
call on one card. It uses only `flash_attention_sm90`,
`flash_attention_reference` and `sm90_kernel_info`, which both have, and,
where the checkout has them, the head-dim-64 geometries (`d64_geometry`,
`_sm90_launch(..., warpgroups=)`).

At each shape (`SHAPES`: the SD 2.1 and SDXL request shapes of a 512²
image, SD 2.1's first level at 640² and 1024² (at 1024² also without CFG,
batch 1), two shapes of whole rounds of 128-row blocks on 132 SMs, and
Flux's L 1280 at D 128 as the unchanged control): out against the plain
version by rel-L2 (bound 1e-2; the plain version a head at a time past L
4096), then the kernel and SDPA's forward queued behind a sleep kernel in
turns (kernel, SDPA, SDPA, kernel; 20 calls each, 10 past L 4096), and
the host's time a call of A (200 calls enqueued behind a sleep kernel). With
`--geometries` also both geometries the launch can take at head dim 64
(2 or 3 consumer warpgroups), in turns. Beside each: the chosen geometry,
its blocks and their rounds over the SMs, the bound (4·B·H·L²·D
operations at 989 TFLOP/s) and the exp floor (B·H·L² exponentials at 3.9
T/s).

With `--requests N`, then N SD 2.1-base 512² requests (50 steps, cfg 4.0,
full width on seeded random weights in bf16) after a 2-step warm-up,
through the checkout's own `chip_smoke` helpers (`_sd_pipeline`,
`_sd_request`: generate_latents_batch then decode_u8), each request's
wall time and A's launches recorded.

Inputs are seeded random. It prints one JSON line, with the card's name and
power limit, and exits 1 when the kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

# label → (B, L, H, D, calls a request)
SHAPES = {
    "sd21_L4096": (2, 4096, 5, 64, 250), "sd21_L1024": (2, 1024, 10, 64, 250), "sd21_L256": (2, 256, 20, 64, 250),
    "sdxl_b1_L1024": (1, 1024, 10, 64, 20), "sdxl_b1_L256": (1, 256, 20, 64, 120),
    "sdxl_b4_L1024": (4, 1024, 10, 64, 20), "sdxl_b4_L256": (4, 256, 20, 64, 120),
    "sd21_640_L6400": (2, 6400, 5, 64, 250), "sd21_1024_L16384": (2, 16384, 5, 64, 250),
    "sd21_1024_nocfg_L16384": (1, 16384, 5, 64, 250),
    "whole_L4096_BH33": (1, 4096, 33, 64, 0), "whole_L1024_BH33": (1, 1024, 33, 64, 0),
    "flux_L1280_D128": (1, 1280, 24, 128, 228),
}
PEAK_BF16_FLOPS, PEAK_EXP_S = 989e12, 3.9e12
REL_TOL = 1e-2


def _queued_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls between CUDA events,
    enqueued behind a sleep kernel so that the host's cost does not show."""
    import torch

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


def _host_us(fn, iters: int = 200) -> float:
    """Mean host time of one fn() call in µs over `iters` calls enqueued
    behind a sleep kernel, so that the device never holds the host back:
    the wrapper's own cost a call (checks, geometry, launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / iters * 1e6


def _in_turns(fns: dict, iters: int) -> dict:
    items = list(fns.items())
    out = {name: [] for name in fns}
    for name, fn in items + items[::-1]:
        out[name].append(_queued_ms(fn, iters))
    return out


def _plain(fa, q, k, v):
    """The plain version in f32, a head at a time past L 4096 → out."""
    import torch

    if q.shape[1] <= 4096:
        return fa.flash_attention_reference(q.float(), k.float(), v.float())[0]
    return torch.cat([fa.flash_attention_reference(q[:, :, i:i + 1].float(), k[:, :, i:i + 1].float(),
                                                   v[:, :, i:i + 1].float())[0] for i in range(q.shape[2])], 2)


def measure(fa, names, with_geometries: bool, sms: int, dev) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(4321)
    geometry = getattr(fa, "d64_geometry", None)
    launch = getattr(fa, "_sm90_launch", None)
    rows, ok = {}, True
    for name in names:
        b, length, h, d, per_request = SHAPES[name]
        q, k, v = (torch.randn((b, length, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        out, _ = fa.flash_attention_sm90(q, k, v)
        ref = _plain(fa, q, k, v)
        rel = ((out.float() - ref).norm() / ref.norm()).item()
        ok &= rel <= REL_TOL
        del ref
        iters = 20 if length <= 4096 else 10
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {"A": lambda: fa.flash_attention_sm90(q, k, v),
                 "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)}
        turns = _in_turns(calls, iters)
        host_us = _host_us(calls["A"])
        rows_a_block = 64 * geometry(b * h, length, sms) if geometry is not None and d == 64 else 128
        blocks = b * h * math.ceil(length / rows_a_block)
        rec = dict(b=b, l=length, h=h, d=d, launches_a_request=per_request, out_rel_l2=rel, turns_ms=turns,
                   host_us=host_us,
                   a_ms=sum(turns["A"]) / 2, sdpa_ms=sum(turns["sdpa"]) / 2, rows_a_block=rows_a_block,
                   blocks=blocks, rounds=blocks / sms,
                   bound_ms=4 * b * h * length * length * d / PEAK_BF16_FLOPS * 1e3,
                   exp_floor_ms=b * h * length * length / PEAK_EXP_S * 1e3)
        if with_geometries and launch is not None and d == 64:
            fns = {}
            for w in fa.WARPGROUPS_D64:
                fns[f"w{w}"] = (lambda w=w: launch(q, k, v, d ** -0.5, warpgroups=w))
                o_v, _ = fns[f"w{w}"]()
                ref = _plain(fa, q, k, v)
                r = ((o_v.float() - ref).norm() / ref.norm()).item()
                ok &= r <= REL_TOL
                del ref, o_v
                rec.setdefault("variant_rel_l2", {})[f"w{w}"] = r
            rec["variants_in_turns_ms"] = _in_turns(fns, iters)
        rows[name] = rec
        print(f"[prof_flash_d64] {name} (B {b}, L {length}, H {h}, D {d}): rel-L2 {rel:.3e} | A "
              f"{' '.join(f'{t:.4f}' for t in turns['A'])} ms, SDPA {' '.join(f'{t:.4f}' for t in turns['sdpa'])} "
              f"ms (A/SDPA {rec['a_ms'] / rec['sdpa_ms']:.3f}), host {host_us:.1f} µs a call | {rows_a_block} rows "
              f"a block: "
              f"{blocks} blocks, {rec['rounds']:.2f} rounds | bound {rec['bound_ms']:.4f}, exp floor "
              f"{rec['exp_floor_ms']:.4f}"
              + (" | geometries " + ", ".join(f"{s} {sum(t) / 2:.4f}" for s, t in rec["variants_in_turns_ms"].items())
                 if "variants_in_turns_ms" in rec else ""), flush=True)
        del q, k, v, qs, ks, vs, out
        torch.cuda.empty_cache()
    return dict(cases=rows, within_tolerance=ok)


def sd_requests(n: int) -> list:
    """n SD 2.1-base 512² requests as chip_smoke's main-sd drives them (50
    steps, cfg 4.0), after a 2-step warm-up → their records."""
    import chip_smoke as cs
    from flux_generator_tpu_torch.pipelines.sd import StableDiffusion

    pipe, _ = cs._sd_pipeline(StableDiffusion, "stable-diffusion-2-1-base", "SD 2.1-base")
    cs._sd_request(pipe, "SD 2.1 warm-up (2 steps, not counted)", [cs.SD_PROMPTS[0][1]], [0], 2, cs.SD21_CFG)
    out = []
    for i in range(n):
        seed, prompt = cs.SD_PROMPTS[i % len(cs.SD_PROMPTS)]
        rec, _, _ = cs._sd_request(pipe, f"SD 2.1 request seed={seed}", [prompt], [seed], cs.SD21_STEPS,
                                   cs.SD21_CFG)
        out.append(dict(seed=seed, latency_s=rec["latency_s"], denoise_s=rec["denoise_s"],
                        flash_launches=rec["flash_launches"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="checkout whose flux_generator_tpu_torch is measured")
    ap.add_argument("--label", default="", help="a name for this run in the output")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    ap.add_argument("--geometries", action="store_true", help="also time both head-dim-64 geometries")
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated names of SHAPES")
    ap.add_argument("--requests", type=int, default=0, help="then time this many SD 2.1 512² requests")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.runtime.device import as_device

    dev = as_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[dev.index or 0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    info = {d: fa.sm90_kernel_info(d) for d in (64, 128)}
    res = measure(fa, [s for s in args.shapes.split(",") if s], args.geometries, sms, dev)
    if args.requests:
        res["sd21_requests"] = sd_requests(args.requests)
        print(f"[prof_flash_d64] SD 2.1 512² requests: "
              + ", ".join(f"{r['latency_s']:.4f}" for r in res["sd21_requests"]) + " s", flush=True)
    rec = dict(label=args.label, root=args.root, device=card, sms=sms, kernel_info=info, **res,
               seconds=time.perf_counter() - t0)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if res["within_tolerance"] else 1


if __name__ == "__main__":
    sys.exit(main())
