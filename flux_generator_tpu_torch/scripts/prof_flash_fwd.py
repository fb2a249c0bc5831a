"""Kernel A's bf16 forward (`flash_attention_sm90`) at Flux's head-dim-128
shapes and the SD and SDXL UNet's head-dim-64 ones, in turns with SDPA's
forward, for one checkout or for comparing two on one card.

    python3 flux_generator_tpu_torch/scripts/prof_flash_fwd.py [--root DIR] [--label NAME] [--out FILE]
        [--geometries] [--shapes NAME,...] [--turns N] [--requests N]

The package is imported from DIR (by default the checkout that holds this
file), so that the same measurement runs on another commit unpacked there
(`git archive`); to compare two, run parent, change, change, parent in one
call on one card. It uses only `flash_attention_sm90`,
`flash_attention_reference` and `sm90_kernel_info`, which every checkout
since the kernel's redesign has, and, where the checkout has them, the
head-dim-64 geometries (`d64_geometry`, `_sm90_launch(..., warpgroups=)`)
and the three-warpgroup kernel's split of its last round over keys
(`d64_split`, `d64_tail`, `_sm90_launch(..., split=False)`).

At each shape (`SHAPES`: Flux's L 1280 and 16640 with 24 heads of 128, the
tensor-parallel head shards of L 1280 (12 and 6 heads), the ring's folds of
L 16640 over 2 and 4 ranks (L 8320, 4160), Flux-dev's training forward (L
1536), L 1000; at head dim 64 the SD 2.1 and SDXL request shapes of a 512²
image, SD 2.1's first level at 640² and 1024² (at 1024² also without CFG),
two shapes of whole rounds of 128-row tiles on 132 SMs, and the rest of the
head-dim-64 shapes whose geometry the CPU tests pin): out against
the plain version by rel-L2 (bound 1e-2; the plain version a head at a time
past L 4096) and its time (CUDA events, the mean of 3 calls), then the
kernel and SDPA's forward queued behind a sleep kernel in turns (kernel, SDPA, SDPA, kernel, that `--turns` times over; 20
calls each, 10 past L 4096, 5 past L 8320), and the host's time a call of A
(200 calls enqueued behind a sleep kernel). With `--geometries` also both geometries the launch can take
at head dim 64 (2 or 3 consumer warpgroups; at 3 also in whole tiles, where
the checkout splits the last round), in turns. Beside each: the geometry
(consumer warpgroups, rows a tile, tiles, CTAs launched, tail CTAs and the
last round's tiles split and their parts), the tiles' rounds over the SMs,
the bound (4·B·H·L²·D operations at 989 TFLOP/s) and the exp floor (B·H·L²
exponentials at 3.9 T/s).

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

# label → (B, L, H, D, calls a request or micro-step on the main paths; 0 off them)
SHAPES = {
    "flux_L1280_H24": (1, 1280, 24, 128, 228), "flux_L16640_H24": (1, 16640, 24, 128, 228),
    "tp2_L1280_H12": (1, 1280, 12, 128, 0), "tp4_L1280_H6": (1, 1280, 6, 128, 0),
    "ring2_L8320_H24": (1, 8320, 24, 128, 0), "ring4_L4160_H24": (1, 4160, 24, 128, 0),
    "dev_L1536_H24": (1, 1536, 24, 128, 114), "short_L1000_H24": (1, 1000, 24, 128, 0),
    "sd21_L4096": (2, 4096, 5, 64, 250), "sd21_L1024": (2, 1024, 10, 64, 250), "sd21_L256": (2, 256, 20, 64, 250),
    "sdxl_b1_L1024": (1, 1024, 10, 64, 20), "sdxl_b1_L256": (1, 256, 20, 64, 120),
    "sdxl_b4_L1024": (4, 1024, 10, 64, 20), "sdxl_b4_L256": (4, 256, 20, 64, 120),
    "sd21_640_L6400": (2, 6400, 5, 64, 250), "sd21_1024_L16384": (2, 16384, 5, 64, 250),
    "sd21_1024_nocfg_L16384": (1, 16384, 5, 64, 250),
    "whole_L4096_BH33": (1, 4096, 33, 64, 0), "whole_L1024_BH33": (1, 1024, 33, 64, 0),
    # the rest of tests/test_torch_flash_attention.py's D64_GEOMETRIES
    "pin_L4096_BH2": (1, 4096, 2, 64, 0), "pin_L300_BH6": (2, 300, 3, 64, 0), "pin_L1000_BH20": (2, 1000, 10, 64, 0),
    "pin_L4160_BH5": (1, 4160, 5, 64, 0), "pin_L129_BH2": (1, 129, 2, 64, 0), "pin_L1_BH8": (4, 1, 2, 64, 0),
    "pin_L48_BH65600": (1, 48, 65600, 64, 0),
}
PEAK_BF16_FLOPS, PEAK_EXP_S = 989e12, 3.9e12
REL_TOL = 1e-2
KEY_TILE = 128


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


def _in_turns(fns: dict, iters: int, turns: int = 1) -> dict:
    """Each fn timed in turns, in the order given then reversed, `turns`
    times over (so a drift of the card's clock falls on each alike) →
    name → its times, in the order taken."""
    items = list(fns.items())
    out = {name: [] for name in fns}
    for name, fn in (items + items[::-1]) * turns:
        out[name].append(_queued_ms(fn, iters))
    return out


def _plain(fa, q, k, v):
    """The plain version in f32, a head at a time past L 4096 → out."""
    import torch

    if q.shape[1] <= 4096:
        return fa.flash_attention_reference(q.float(), k.float(), v.float())[0]
    return torch.cat([fa.flash_attention_reference(q[:, :, i:i + 1].float(), k[:, :, i:i + 1].float(),
                                                   v[:, :, i:i + 1].float())[0] for i in range(q.shape[2])], 2)


def _plain_ms(fa, q, k, v, calls: int = 3) -> float:
    """Mean time of `calls` runs of the plain version (after one already run)
    between CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        _plain(fa, q, k, v)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _iters(length: int) -> int:
    return 20 if length <= 4096 else 10 if length <= 8320 else 5


def _geometry(fa, b: int, length: int, h: int, d: int, sms: int) -> dict:
    """The launch's consumer warpgroups (the checkout's `d64_geometry` where
    it has one), rows a tile, tiles and CTAs: at two warpgroups the
    persistent kernel's one an SM up to one a tile (a checkout from before
    that kernel launched one a tile there too), at three `d64_split`'s CTAs
    and tail CTAs, with the last round's tiles split and their most parts,
    where the checkout has it (one a tile before)."""
    w = fa.d64_geometry(b * h, length, sms) if d == 64 and hasattr(fa, "d64_geometry") else 2
    rows = 64 * w
    tiles = b * h * math.ceil(length / rows)
    ctas, tail, parts = min(tiles, sms), 0, []
    if w == 3 and hasattr(fa, "d64_split"):
        ctas, tail, _ = fa.d64_split(b * h, length, sms)
        parts = fa.d64_tail(b * h, length, ctas, tail)
    elif w == 3:
        ctas = tiles
    split = [p for p in parts if p > 1]
    return dict(warpgroups=w, rows_a_tile=rows, tiles=tiles, ctas=ctas, rounds=tiles / sms, tail_ctas=tail,
                split_tiles=len(split), most_parts=max(split, default=1))


def measure(fa, names, with_geometries: bool, sms: int, dev, n_turns: int = 1) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(4321)
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
        plain_ms = _plain_ms(fa, q, k, v)
        iters = _iters(length)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls = {"A": lambda: fa.flash_attention_sm90(q, k, v),
                 "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)}
        turns = _in_turns(calls, iters, n_turns)
        host_us = _host_us(calls["A"])
        geo = _geometry(fa, b, length, h, d, sms)
        rec = dict(b=b, l=length, h=h, d=d, launches_a_request=per_request, out_rel_l2=rel, plain_ms=plain_ms,
                   turns_ms=turns,
                   host_us=host_us, a_ms=sum(turns["A"]) / len(turns["A"]),
                   sdpa_ms=sum(turns["sdpa"]) / len(turns["sdpa"]), **geo,
                   key_tiles=math.ceil(length / KEY_TILE),
                   bound_ms=4 * b * h * length * length * d / PEAK_BF16_FLOPS * 1e3,
                   exp_floor_ms=b * h * length * length / PEAK_EXP_S * 1e3)
        if with_geometries and launch is not None and d == 64:
            fns = {}
            for w in fa.WARPGROUPS_D64:
                fns[f"w{w}"] = (lambda w=w: launch(q, k, v, d ** -0.5, warpgroups=w))
            if hasattr(fa, "d64_split") and max(fa.d64_tail(b * h, length, *fa.d64_split(b * h, length, sms)[:2]),
                                                default=1) > 1:  # three warpgroups split the last round here
                fns["w3_whole"] = lambda: launch(q, k, v, d ** -0.5, warpgroups=3, split=False)
            for var, fn in fns.items():
                o_v, _ = fn()
                ref = _plain(fa, q, k, v)
                r = ((o_v.float() - ref).norm() / ref.norm()).item()
                ok &= r <= REL_TOL
                del ref, o_v
                rec.setdefault("variant_rel_l2", {})[var] = r
            rec["variants_in_turns_ms"] = _in_turns(fns, iters)
        rows[name] = rec
        print(f"[prof_flash_fwd] {name} (B {b}, L {length}, H {h}, D {d}): rel-L2 {rel:.3e} | A "
              f"{' '.join(f'{t:.4f}' for t in turns['A'])} ms, SDPA {' '.join(f'{t:.4f}' for t in turns['sdpa'])} "
              f"ms (A/SDPA {rec['a_ms'] / rec['sdpa_ms']:.3f}), plain {plain_ms:.3f} ms, host {host_us:.1f} µs a call | "
              f"{geo['warpgroups']} consumer warpgroups, {geo['rows_a_tile']} rows a tile: {geo['tiles']} tiles on "
              f"{geo['ctas']} CTAs, {geo['rounds']:.2f} rounds, {geo['tail_ctas']} tail CTAs, "
              f"{geo['split_tiles']} tiles split into at most {geo['most_parts']} parts | bound "
              f"{rec['bound_ms']:.4f}, exp floor "
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
    ap.add_argument("--turns", type=int, default=1, help="times over that A and SDPA are timed in turns")
    ap.add_argument("--requests", type=int, default=0, help="then time this many SD 2.1 512² requests")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.runtime.device import as_device

    dev = as_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[dev.index or 0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    names = [s for s in args.shapes.split(",") if s]
    info = {d: fa.sm90_kernel_info(d, 2) for d in (64, 128)}
    res = measure(fa, names, args.geometries, sms, dev, args.turns)
    if args.requests:
        res["sd21_requests"] = sd_requests(args.requests)
        print(f"[prof_flash_fwd] SD 2.1 512² requests: "
              + ", ".join(f"{r['latency_s']:.4f}" for r in res["sd21_requests"]) + " s", flush=True)
    rec = dict(label=args.label, root=str(root), device=card, sms=sms, kernel_info=info, **res,
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
