#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flux_generator_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. device         — the card's name and power limit; no CUDA device is an error.
  2. build          — compile the ten CUDA sources (kernels A-H, A's bf16
                      mode in its own source, the decode-chain probe #11, the
                      chain-bisect probe #12 and the bare-dot probe #13) from
                      csrc/ with nvcc, all at once, with the ptxas report of
                      each and the registers, local memory, shared memory and
                      blocks an SM of the wgmma kernels: A's bf16 kernel, B's
                      five instantiations (with their ring stages and tiles),
                      E and F, G's GEMM and #13's bf16 kernel, and of D's four
                      instantiations with its ring stages, grid syncs a
                      layer and SASS size; B, E, F, G, #13 and D must not
                      spill nor have their wgmma serialized (C7512, C7515).
  3. kernels        — flash attention (A: its RoPE pre-pass and its bf16
                      kernel) and the int4 matmul (B) against their plain
                      PyTorch versions at the shapes of the Flux-schnell 512²
                      path, with times of both, A's in turns with SDPA's
                      forward; B at the three T5-XXL shapes at M 256 and
                      M 512 (g128) and 4096² per channel, in turns with
                      tinygemm and with cuBLAS's bf16 product on the
                      dequantized weights, with a request's sums, every K
                      split at M 256, one-hot rows bit for bit, and at one
                      row, 17 rows, a ragged N and with f32 activations.
  4. kernels-music  — the LSTM (C) and the fused decode step (D) against their
                      plain versions at MusicGen-medium shapes, with times;
                      D at int8 B 2 and B 8 in turns with #11 at M 2 and M 8,
                      and B 8's rows 0-1 bit for bit against a B 2 launch.
     kernels-musicgen-f8 — D's e4m3 cache tier against its plain version at
                      MusicGen-medium shapes (B 2 W 2500, B 8 W 2048, bf16
                      weights B 2 W 500), timed in turns with the bf16 tier.
     kernels-chain  — the decode-chain probe (#11) against its plain version
                      at 48 layers, M 8, timed in turns with D (bf16 cache,
                      B 2, W 500) on the same weights; then the probe's entry
                      point (scripts/prof_decode_chain.run).
     kernels-chain-bisect — the chain-bisect probe (#12) against its plain
                      version at 48 layers, M 8 and M 2, for its eight
                      cumulative rungs (no extras, then smem, ln, cross, hbm,
                      bufs, outs, dma added in turn), each timed in turns with
                      #11 on the same weights; a control that must miss the
                      tolerance; each rung's cost over the one before beside
                      D − #11; then the probe's entry point
                      (scripts/prof_chain_bisect.run: the script's ladder,
                      then every extra).
  5. kernels-train  — the flash backward, dQ (E) and dK/dV (F), through the
                      autograd function against the plain backward in f32 at
                      the Flux-dev and Flux-schnell training shapes, a padded
                      length and head dim 64, with times of E, F, the plain
                      backward, and the pair and the whole backward route in
                      turns with SDPA's backward as a yardstick; at L 1536
                      the tail (the last wave whole, F after E's end, 22
                      heads).
  6. kernels-w8a8   — the fused W8A8 matmul (G) at every dense shape of a
                      Flux 512² request (G_SHAPES), bit for bit against its
                      plain version, timed in turns with torch._int_mm on the
                      quantized operands and with the "rows" route, its
                      quantizer pass and GEMM apart, and the request-weighted
                      sums; the row quantizer (H) and A's int8 tiers ("qk",
                      "full") against their plain versions, with times and
                      bounds.
     kernels-bare-dot — the bare-dot probe #13 in its three modes (bf16, int8,
                      int8 quantized inside) at 64 steps of (1024, 128)·(128,
                      1024), bf16 in turns with torch.bmm, its yardstick.
     kernels-flash-streamed — A through flash_attention_streamed at L 16640
                      (the 2048² sequence): "", "qk" and "full" in groups of
                      1024 keys, held to their plain versions two heads at a
                      time, the bf16 mode in turns with SDPA's forward and
                      its two stages timed alone; the streamed "full" at
                      L 1280 in groups of 64 and 1024; then the probe's entry
                      point, scripts/prof_attn_int8.run (8 steps).
  7. main           — Flux-schnell at full width on random weights (flow int8
                      per channel, T5-XXL int4 g=128), three 512², 4-step
                      requests through FluxPipeline.generate_images; checks the
                      images, the latents and the kernels' launch counts; then
                      the conditioning alone under torch.profiler.
  8. main-w8a8      — the same pipeline in the W8A8 configuration: three
                      requests each on the "fused" (G) and "rows" (H) routes,
                      one each with int8 attention "qk" and "full"; checks as
                      main, exact launch counts, and each final latent's
                      rel-L2 against the weight-only latent of its seed;
                      weight-only and "fused" requests in turns; one of each
                      under torch.profiler.
     main-2048      — the same pipeline (weight-only) through the server's
                      generator protocol at 2048²: generate_latents + decode_u8
                      (4 steps, tiled decode), then img2img on that image
                      (generate_latents_from_image, strength 0.5, tiled
                      encode): phase split, peak memory, exact launch counts,
                      the request under torch.profiler; at 512²
                      generate_images_fused equal to generate_images byte for
                      byte, with no host synchronisation inside it.
  9. main-musicgen  — MusicGen-medium at full width on random weights (decoder
                      and T5-base int8 per channel, EnCodec f32), three
                      500-step requests through MusicGenPipeline.generate;
                      checks the waveforms, the codes and the launch counts.
     main-musicgen-serve — the same pipeline serving four users at once
                      through generate_requests (250/500/1000/1500 steps,
                      seeds 1-4), on bf16 and on e4m3 caches; then at top_k 1
                      each request's codes coalesced against its solo run.
     main-musicgen-long — one 2500-step request on bf16 and e4m3 caches in
                      turns, with the device ms a step at its start and end.
 10. main-train     — DreamBooth LoRA training of Flux-dev at full width on
                      random weights through training.dreambooth.train: 3
                      optimizer steps of 4 micro-steps on two seeded images;
                      checks losses, the adapters and the launch counts (A,
                      its RoPE pre-pass, E, F and B).
 11. small          — a small Flux config run on the card (bf16, kernels) and on
                      the CPU (f32, plain versions) from the same weights and noise.
     small-tiled    — the same config past the untiled sizes: a tiled decode
                      (latent 136²) and an img2img with a tiled encode, card
                      against CPU.
 12. small-w8a8     — the same small config with an int8 flow in the W8A8
                      configuration ("fused" + "qk", "rows" + "full") on the
                      card and on the CPU.
 13. small-musicgen — a small MusicGen config (ffn = 4h, head dim 64) on the card
                      and on the CPU: teacher-forced logits and a decoded waveform.
 14. small-train    — a small Flux config: the training loss and its LoRA
                      gradients on the card (bf16) against the CPU (f32).
The last line printed is {"ok": true, "device": {...}}; a fuller record goes
to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --profile-train

instead profiles one optimizer step (4 micro-steps) of the main-train
configuration through the trainer's step function under torch.profiler
(device time by kernel group, busy share, per micro-step) into
chiprun_out/profile_train.json.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

FLASH_TOL = 2e-2  # bf16 P·V and bf16 output against the f32 plain version
# A's int8 tiers against their plain versions: (out rel-L2, lse max|Δ|).
# Both sides quantize alike and take exact integer dots; "qk" rounds P to
# bf16 against a running max, "full" may move one int8 level of p near a .5
# boundary, and both round O to bf16 (measured 2.4e-3 and 2.0e-3 at most on
# an H100 80GB HBM3 at 700 W). The out bound lies between that and the distance of every
# control (the bf16 function, 9.2e-3 at least; for "full" also the "qk" and
# the streamed tier, 2.6e-2 at least), which the run checks. lse as the bf16
# tier's: a rotated q value that rounds the other way moves its row's logits
# by one int8 level of q.
INT8_ATTN_TOL = {"qk": (4.5e-3, FLASH_TOL), "full": (7e-3, FLASH_TOL)}
# A's bf16 tier at the 2048² geometry (L 16640) against its plain version:
# (out rel-L2, lse max|Δ|). bf16 P and O rounding, f32 sums in another order
# (measured 2.4e-3 and 1.9e-6 on an H100 80GB HBM3 at 700 W). Two controls
# must fail it: the "qk" tier's output, and the plain function with the last
# 256 keys (the partial 1024-key block) dropped, which moves lse by about
# log(16640/16384) ≈ 1.6e-2.
FLASH_LONG_TOL = (4e-3, 1e-4)
# flash backward, of max|ref|: P and dS rounded to bf16 before their products,
# bf16 outputs, against the f32 plain backward
FLASH_BWD_REL_TOL = 2e-2
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 and int8 tensor
# cores, HBM
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES_S = 989e12, 1979e12, 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
TRAIN_ARGS = ["--model", "dev", "--quantize-base", "--lora-rank", "8", "--resolution", "512x512",
              "--batch-size", "1", "--grad-accumulate", "4", "--num-augmentations", "2",
              "--warmup-steps", "1", "--progress-every", "0", "--checkpoint-every", "3",
              "--iterations", "3", "--random-weights",
              "--t5-tokenizer", str(ROOT / "tests/assets/spiece/t5_like.model"),
              "--clip-tokenizer", str(ROOT / "tests/assets/clip_tokenizer")]
TRAIN_PROMPTS = ["a photo of sks dog on a beach", "a photo of sks dog in a red bucket"]
INT4_REL_TOL = 1e-2  # of max|ref|: the bf16 output rounding is 2^-9 relative
# G's dense shapes in a Flux-schnell 512² request (name, M, K, N, launches a
# request of 4 steps): the 38 single blocks' linear1 and linear2 (1280 tokens),
# the 19 double blocks' image (1024 tokens) and text (256) qkv, proj, mlp0 and
# mlp2, txt_in and the final linear: 920 launches
G_SHAPES = (("linear1", 1280, 3072, 21504, 152), ("linear2", 1280, 15360, 3072, 152),
            ("mlp0", 1024, 3072, 12288, 76), ("mlp2", 1024, 12288, 3072, 76),
            ("qkv", 1024, 3072, 9216, 76), ("proj", 1024, 3072, 3072, 76),
            ("txt_qkv", 256, 3072, 9216, 76), ("txt_proj", 256, 3072, 3072, 76),
            ("txt_mlp0", 256, 3072, 12288, 76), ("txt_mlp2", 256, 12288, 3072, 76),
            ("txt_in", 256, 4096, 3072, 4), ("final", 1024, 3072, 64, 4))
# B's T5-XXL shapes (name, K, N, launches a request: 24 layers of q, k, v, o
# at 4096→4096, wi_0 and wi_1 at 4096→10240, wo at 10240→4096)
T5_SHAPES = (("qkvo_4096x4096_g128", 4096, 4096, 96), ("wi_4096x10240_g128", 4096, 10240, 48),
             ("wo_10240x4096_g128", 10240, 4096, 24))
# a W8A8 request's final latent against the weight-only latent of its seed:
# activation rounding (1/254 of a row's amax a value) through 57 blocks and
# 4 steps on random weights; a wrong route or scale gives O(1)
W8A8_LATENT_REL_TOL = 0.1
SMALL_REL_TOL = 5e-2  # relative L2, bf16 on the card against f32 on the CPU
STEPS, SIZE = 4, 512
PROMPTS = [
    (1, "a photograph of a red fox in fresh snow"),
    (2, "an oil painting of a lighthouse at dusk"),
    (3, "a macro shot of dew on a spider web"),
]
# LSTM, bf16 Wh: f32 states in another summation order; a bf16-rounded h can
# flip by one ulp (2^-8) and carry into later steps
LSTM_TOL = {"bf16": 2e-3, "f32": 1e-4}
# decode step, of max|y|: 48 layers of bf16-rounded dot inputs in another
# summation order
DECODE_REL_TOL = 2e-2
MG_STEPS, MG_TOP_K = 500, 250
MG_PROMPTS = [
    (11, "happy rock"),
    (12, "an upbeat electronic track with a driving bassline"),
    (13, "slow piano ballad in a minor key"),
]
# the served MusicGen path: four users' requests in one loop (the JAX
# server's music endpoint coalesces at most 4), prompts of different lengths
SERVE_TEXTS = [t for _, t in MG_PROMPTS] + [
    "a calm acoustic guitar melody over soft rain, recorded in a small wooden room"]
SERVE_STEPS = (250, 500, 1000, 1500)
SERVE_EQUAL_STEPS = (64, 96, 128, 160)  # the top_k 1 coalesced-against-solo check
LONG_STEPS = 2500  # the JAX package's longest request (about 50 s of audio)
# D's e4m3 tier against its plain version, of max|y|: the bf16 tier's bound,
# the same arithmetic in another summation order. Layer 0's new rows, whose
# inputs are equal, are held to the plain version's bytes: equal or one e4m3
# step apart (a bf16 row one ulp apart may round either way). Against the
# bf16 tier run on the widened caches (the same kernel arithmetic) y and the
# encoded new rows of every layer are held byte for byte.
DECODE_F8_REL_TOL = 1e-2
# the chain probes (#11, #12), of max|y| (and #12's max|kn|, max|vn|), as D
CHAIN_REL_TOL = 1e-2


def log(*args):
    print(*args, flush=True)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least time in ms, "operations" or "bytes") at the card's `peak`
    (bf16 unless given) and memory rate."""
    return bound_ms_parts([(flops, peak)], nbytes)


def bound_ms_parts(parts, nbytes: float):
    """As bound_ms for work of several types: `parts` is [(operations,
    peak), ...], whose times at their peaks add up."""
    t_ops = sum(ops / peak for ops, peak in parts) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_queued(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, enqueued
    behind a sleep kernel of about 10 ms so that the host's cost between
    calls (a wrapper's checks and launch) does not show: for calls of tens of
    µs. CUDA events around the calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # cycles: the device waits while the host enqueues
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int = 20) -> dict:
    """Each fn of `fns` timed by time_ms_queued in turns, in order and then in
    reverse (a, b, b, a for two) → {name: [ms, ms]}."""
    items = list(fns.items())
    out = {name: [] for name, _ in items}
    for name, fn in items + items[::-1]:
        out[name].append(time_ms_queued(fn, iters))
    return out


def device_ms_by_kernel(fn, iters: int = 10, warmup: int = 3) -> dict:
    """Mean device time per fn() call of each CUDA kernel that fn launches,
    {name: ms}, under torch.profiler."""
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
        times = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                times[ev.name] = times.get(ev.name, 0.0) + ev.device_time_total / 1e3 / iters
        if sum(times.values()) > 0:
            return times
    raise RuntimeError("torch.profiler recorded no device time in three tries")


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean device time per fn() call: the sum of its CUDA kernels' times
    under torch.profiler. For library calls whose host-side cost (the
    autograd engine, SDPA's dispatch) would swamp CUDA-event timing at these
    sizes."""
    return sum(device_ms_by_kernel(fn, iters, warmup).values())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # f32 references on the card run in full f32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    return smi, name


def phase_build():
    from flux_generator_tpu_torch.ops.kernels import _build
    from flux_generator_tpu_torch.ops.kernels import bare_dot as bd
    from flux_generator_tpu_torch.ops.kernels import chain_bisect as cb
    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import lstm as lk
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm

    sources = dict(fa.BUILDS)  # flash_attention_sm90 (A's bf16 mode) and flash_attention (its int8 tiers)
    sources.update({name: mod._SIGNATURES for name, mod in (
        ("int4_matmul", im), ("lstm", lk), ("decode_step", ds), ("flash_attention_bwd", fb),
        ("w8a8_matmul", wm), ("decode_chain", dc), ("bare_dot", bd), ("chain_bisect", cb))})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        futures = {name: pool.submit(_build.load, name, sigs) for name, sigs in sources.items()}
        for fut in futures.values():
            fut.result()
    log(f"[build] all {len(sources)} sources: {time.perf_counter() - t0:.2f} s")
    for name in sources:
        nvcc_s, report = _build.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {nvcc_s:.2f} s")
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "C7512", "arning")):
                log(f"[build]   {line.strip()}")
    info = {d: fa.sm90_kernel_info(d) for d in fa.HEAD_DIMS}
    for d, rec in info.items():
        log(f"[build] flash_attention_sm90 D {d}: {rec['registers']} registers a thread at launch "
            f"(setmaxnreg: 40 producer, 232 consumers), {rec['spill_bytes']} bytes of local memory, "
            f"{rec['smem_bytes']} bytes of shared memory a block, {rec['blocks_per_sm']} block(s) an SM")
    if any("C7512" in line for line in _build.BUILD_INFO["flash_attention_sm90"][1].splitlines()):
        log("[build] WARNING: ptxas serialized flash_attention_sm90's wgmma (C7512)")
    bwd_info = {d: fb.kernel_info(d) for d in fb.HEAD_DIMS}
    for d, recs in bwd_info.items():
        for which, rec in recs.items():
            log(f"[build] flash_attention_bwd {'E' if which == 'dq' else 'F'} ({which}) D {d}: "
                f"{rec['registers']} registers a thread at launch (setmaxnreg: 40 producer, 232 consumers), "
                f"{rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of shared memory a "
                f"block, {rec['blocks_per_sm']} block(s) an SM")
    g_info = {f"{bk}x{bn}": wm.kernel_info(bk, bn) for bk in wm.BK_CANDIDATES for bn in wm.TILE_WIDTHS}
    dot_info = {k: bd.bf16_kernel_info(k) for k in (bd.K_RANGE[0], 128, bd.K_RANGE[1])}
    for label, recs in (("w8a8_matmul G GEMM, K block x tile width", g_info), ("bare_dot bf16, K", dot_info)):
        for key, rec in recs.items():
            log(f"[build] {label} {key}: {rec['registers']} registers a thread at launch (setmaxnreg: 40 "
                f"producer, 232 consumers), {rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} "
                f"bytes of shared memory a block, {rec['blocks_per_sm']} block(s) an SM")
    b_info = {f"{nw} rows, {mode}": im.kernel_info(nw, mode) for nw in im.ROW_TILES for mode in im.SCALE_MODES
              if nw == 128 or mode != "group_row"}
    for key, rec in b_info.items():
        nw = int(key.split()[0])
        log(f"[build] int4_matmul B, {key} scales: {rec['registers']} registers a thread at launch (setmaxnreg: 40 "
            f"producer, 232 consumers), {rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of "
            f"shared memory a block, {rec['blocks_per_sm']} block(s) an SM, a ring of {rec['stages']} stages, tiles "
            f"of {nw} rows × {im.TILE_N} columns, K split in clusters of up to {im.MAX_SPLITS[nw]} blocks")
    d_info = {f"{'int8' if i8 else 'bf16'} weights, {'e4m3' if f8 else 'bf16'} cache": ds.kernel_info(i8, f8)
              for i8 in (True, False) for f8 in (False, True)}
    for key, rec in d_info.items():
        log(f"[build] decode_step D, {key}: {rec['registers']} registers a thread, {rec['local_bytes']} bytes of "
            f"local memory (its calls' stack), {rec['smem_bytes']} bytes of shared memory a block, "
            f"{rec['blocks_per_sm']} block(s) an "
            f"SM, a weight ring of {rec['ring_stages']} stages, {rec['syncs_per_layer']} grid syncs a layer "
            f"({rec['syncs_per_layer'] * 48} a 48-layer step)")
    # D's code is fetched anew every layer (its phases each run once a layer): its size an instantiation
    d_so = next(_build.BUILD_DIR.glob("decode_step-*.so"))
    sass = subprocess.run([str(pathlib.Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(d_so)],
                          capture_output=True, text=True, check=True).stdout
    d_code = {}
    for part in sass.split("Function : ")[1:]:
        d_code[part.split(None, 1)[0][-40:]] = sum(1 for line in part.splitlines()
                                                    if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line))
    log("[build] decode_step D code: " + ", ".join(f"{n} instructions ({n * 16 // 1024} KB)" for n in
                                                      d_code.values()) + " an instantiation")
    # B, E, F, G's GEMM and #13's bf16 kernel keep their products asynchronous and in registers;
    # none of them, nor D, spills
    serialized = [line.strip() for name in ("int4_matmul", "flash_attention_bwd", "w8a8_matmul", "bare_dot",
                                            "decode_step")
                  for line in _build.BUILD_INFO[name][1].splitlines() if "C7512" in line or "C7515" in line]
    spills = {(d, w): r["spill_bytes"] for d, recs in bwd_info.items() for w, r in recs.items() if r["spill_bytes"]}
    spills.update({("G", key): r["spill_bytes"] for key, r in g_info.items() if r["spill_bytes"]})
    spills.update({("B", key): r["spill_bytes"] for key, r in b_info.items() if r["spill_bytes"]})
    spills.update({("bare_dot_bf16", k): r["spill_bytes"] for k, r in dot_info.items() if r["spill_bytes"]})
    # D's phases are calls with a stack: its spills are ptxas's, for the kernels and every function
    d_spills = [int(n) for pair in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                              _build.BUILD_INFO["decode_step"][1]) for n in pair]
    if any(d_spills):
        spills[("D", "ptxas")] = max(d_spills)
    if serialized or spills:
        raise AssertionError(f"tensor-core kernels: serialized {serialized}, spills {spills}")
    return {"flash_attention_sm90": info, "flash_attention_bwd": bwd_info, "w8a8_matmul": g_info, "int4_matmul": b_info,
            "bare_dot_bf16": dot_info, "decode_step": d_info, "decode_step_sass_instructions": d_code}


def _flux_rope_tables(length: int, text: int = 256, axes_dim=(16, 56, 56)):
    """cos/sin (1, length, sum(axes_dim) / 2) in bf16 from the real Flux ids:
    `text` text tokens (id 0; 256 for schnell, 512 for dev) then the 512²
    image's 32x32 patch grid; axes (8, 28, 28) give head dim 64."""
    import torch

    from flux_generator_tpu_torch.ops.rope import multi_axis_rope
    from flux_generator_tpu_torch.pipelines.flux import latent_ids

    dev = torch.device("cuda")
    ids = torch.cat([torch.zeros((1, text, 3), dtype=torch.int64, device=dev),
                     latent_ids(1, SIZE // 8, SIZE // 8, device=dev)], dim=1)[:, :length]
    cos, sin = multi_axis_rope(ids, list(axes_dim), 10000.0)
    return cos.to(torch.bfloat16).contiguous(), sin.to(torch.bfloat16).contiguous()


def _tinygemm_operands(kernel_q4, kernel_scale):
    """Kernel B's packed int4 weights in the operands of PyTorch's
    torch._weight_int4pack_mm, for its time as a yardstick only: the
    unsigned nibbles u = q + 8 of (N, K), two per byte along K (even k high),
    through _convert_weight_to_int4pack, and a (groups, N, 2) bf16 table of
    (scale, zero = 0), so that tinygemm's (u − 8)·scale + zero is q·scale.
    Per-channel scales go in as groups of 256 with the scale repeated."""
    import torch

    k = 2 * kernel_q4.shape[0]
    u = torch.cat([kernel_q4 & 15, kernel_q4 >> 4]).t().contiguous()  # split layout → (N, K)
    weight = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).contiguous(), 8)
    if kernel_scale.ndim == 1:
        group_size, scale = 256, kernel_scale[None].expand(k // 256, -1)
    else:
        group_size, scale = k // kernel_scale.shape[0], kernel_scale
    table = torch.stack([scale, torch.zeros_like(scale)], -1).to(torch.bfloat16).contiguous()
    return weight, group_size, table


def phase_kernels():
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.quant import quantize_dense

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # A's bf16 mode: the RoPE pre-pass, then the attention kernel
    # (flash_attention_sm90.cu). Each held to its plain version; the route,
    # the kernel alone and the pre-pass alone timed behind a sleep kernel
    # (time_ms_queued), and the route in turns with SDPA's forward on the
    # pre-rotated q/k in (B, H, L, D).
    flash, rope_rows = [], []
    for label, length, rope in (("L1280_rope", 1280, True), ("L1000_rope_padding", 1000, True),
                                ("L1280_norope", 1280, False)):
        q, k, v = (torch.randn((1, length, 24, 128), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        cos, sin = _flux_rope_tables(length) if rope else (None, None)
        out, lse = fa.flash_attention(q, k, v, cos, sin, return_lse=True)
        f32 = (lambda t: None if t is None else t.float())
        ref, ref_lse = fa.flash_attention_reference(f32(q), f32(k), f32(v), f32(cos), f32(sin))
        err = max((out.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        qr, kr = fa.rope_rotate(q, k, cos, sin) if rope else (q, k)
        route_ms = time_ms_queued(lambda: fa.flash_attention(q, k, v, cos, sin))
        ms = time_ms_queued(lambda: fa.flash_attention_sm90(qr, kr, v))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(qr, kr, v))
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qr, kr, v))
        turns = in_turns({"route": lambda: fa.flash_attention(q, k, v, cos, sin),
                          "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
        library_ms = statistics.mean(turns["sdpa"])
        gflop = 4 * length * length * 128 * 24 / 1e9
        # the attention kernel's function: q, k, v, out bf16, lse f32
        bound = bound_ms(gflop * 1e9, 4 * q.numel() * 2 + length * 24 * 4)
        row = dict(case=label, max_abs_err=err, ms=ms, route_ms=route_ms, plain_ms=plain_ms,
                   library_ms=library_ms, turns_ms=turns, bound_ms=bound[0], bound_by=bound[1],
                   tflops=gflop / ms, bound_share=bound[0] / ms)
        note = ""
        if rope:
            got = fa.rope_rotate(q, k, cos, sin)
            want = fa.rope_rotate_reference(q, k, cos, sin)
            rope_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            rope_ms = time_ms_queued(lambda: fa.rope_rotate(q, k, cos, sin))
            rope_plain_ms = time_ms(lambda: fa.rope_rotate_reference(q, k, cos, sin))
            # q and k read, their rotations written, the two tables read
            rope_bound = bound_ms(0, 4 * q.numel() * 2 + 2 * cos.numel() * 2)
            rope_rows.append(dict(case=label, max_abs_err=rope_err, ms=rope_ms, plain_ms=rope_plain_ms,
                                  library_ms=None, bound_ms=rope_bound[0], bound_by=rope_bound[1]))
            row["rope_ms"] = rope_ms
            note = (f" | pre-pass {rope_ms:.4f} ms (max|Δ| {rope_err:.1e}, must be 0; plain "
                    f"{rope_plain_ms:.4f} ms; bound {rope_bound[0]:.4f} ms, {rope_bound[1]})")
            if rope_err != 0:
                raise AssertionError(f"flash {label}: the RoPE pre-pass differs from its plain version: {rope_err}")
        log(f"[kernels] flash {label}: max|Δ| {err:.3e} (tol {FLASH_TOL}) | route {route_ms:.4f} ms | kernel "
            f"{ms:.4f} ms ({gflop / ms:.1f} TFLOP/s, {100 * bound[0] / ms:.1f}% of the bound {bound[0]:.4f} ms, "
            f"{bound[1]}){note} | plain {plain_ms:.4f} ms | in turns: route "
            f"{' '.join(f'{t:.4f}' for t in turns['route'])}, SDPA fwd {' '.join(f'{t:.4f}' for t in turns['sdpa'])} ms")
        if not err <= FLASH_TOL:
            raise AssertionError(f"flash {label} disagrees with its plain version: {err}")
        flash.append(row)
        del qs, ks, vs, qr, kr
    results["flash_attention"] = flash
    results["flash_attention_rope"] = rope_rows

    results.update(_phase_kernels_int4(g))
    torch.cuda.synchronize()
    return results


def _bf16_weights(kernel_q4, kernel_scale):
    """Kernel B's weights dequantized once to bf16 (K, N), as the plain
    version dequantizes them: cuBLAS's bf16 product on them is the second
    yardstick, a product of the same size that reads 4x the weight bytes."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im

    lo, hi = im._halves(kernel_q4)
    w = torch.cat([lo, hi])
    s = kernel_scale.float()
    s = s.repeat_interleave(w.shape[0] // s.shape[0], dim=0) if s.dim() == 2 else s
    return (w * s).to(torch.bfloat16)


def _phase_kernels_int4(g):
    """Kernel B at the T5-XXL shapes (T5_SHAPES) at M 256 (a Flux request's
    prompt) and M 512 (Flux-dev's), grouped g128, and 4096² per channel: held
    to its plain version, timed behind a sleep kernel in turns with tinygemm
    (torch._weight_int4pack_mm on the same weights repacked once) and with
    cuBLAS's bf16 product on the weights dequantized once; the request sums;
    at M 256 every K split the plan could take, in turns; one-hot rows bit
    for bit against the plain version; then the edge cases the TPU wrapper
    also takes (one row, 17 rows, a ragged N, f32 x)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.quant import quantize_dense

    dev = torch.device("cuda")
    capacity = im._capacity(dev.index or 0)
    clusters = {nw: {sp: capacity(nw, sp) // sp for sp in range(1, im.MAX_SPLITS[nw] + 1)} for nw in im.ROW_TILES}
    log(f"[kernels] int4 clusters of 1.. blocks the card runs at once, by tile rows: {clusters}")
    int4, sums, splits_ms = [], {}, {}
    cases = [(m, label, k, n, 128, per_request) for m in (256, 512) for label, k, n, per_request in T5_SHAPES]
    cases.insert(3, (256, "4096x4096_per_channel", 4096, 4096, None, 0))
    for m, label, k_dim, n_dim, gs, per_request in cases:
        case = label if m == 256 else f"M{m}_{label}"
        w = torch.randn((k_dim, n_dim), generator=g, device=dev) / k_dim ** 0.5
        p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
        del w
        x = torch.randn((m, k_dim), generator=g, device=dev).to(torch.bfloat16)
        out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
        ref = im.int4_matmul_reference(x.float(), p["kernel_q4"], p["kernel_scale"])
        err = (out.float() - ref).abs().max().item()
        tol = INT4_REL_TOL * ref.abs().max().item()
        again = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
        lw, lgs, ltable = _tinygemm_operands(p["kernel_q4"], p["kernel_scale"])
        lib_out = torch._weight_int4pack_mm(x, lw, lgs, ltable)
        lib_err = (lib_out.float() - ref).abs().max().item()
        wb = _bf16_weights(p["kernel_q4"], p["kernel_scale"])
        turns = in_turns({"kernel": lambda: im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"]),
                          "tinygemm": lambda: torch._weight_int4pack_mm(x, lw, lgs, ltable),
                          "cublas_bf16": lambda: x @ wb})
        ms, library_ms, cublas_ms = (statistics.mean(turns[key]) for key in ("kernel", "tinygemm", "cublas_bf16"))
        plain_ms = time_ms(lambda: im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"]))
        gflop = 2 * m * k_dim * n_dim / 1e9
        # x and out bf16, the packed nibbles, the f32 scales
        bound = bound_ms(gflop * 1e9, 2 * m * (k_dim + n_dim) + p["kernel_q4"].numel() + p["kernel_scale"].numel() * 4)
        plan = im.plan(m, n_dim, k_dim, capacity)
        log(f"[kernels] int4 M={m} {label}: plan (rows, splits, blocks) {plan} | max|Δ| {err:.3e} (tol {tol:.3e}) "
            f"| in turns: kernel {' '.join(f'{t:.4f}' for t in turns['kernel'])}, tinygemm "
            f"{' '.join(f'{t:.4f}' for t in turns['tinygemm'])} (max|Δ| {lib_err:.3e}), cuBLAS bf16 on the "
            f"dequantized weights {' '.join(f'{t:.4f}' for t in turns['cublas_bf16'])} ms | "
            f"{gflop / ms:.1f} TFLOP/s, {100 * bound[0] / ms:.1f}% of the bound {bound[0]:.4f} ms ({bound[1]}) | "
            f"plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"int4 {case} disagrees with its plain version: {err} > {tol}")
        if not torch.equal(out, again):
            raise AssertionError(f"int4 {case}: two launches differ")
        if not lib_err <= tol:
            raise AssertionError(f"int4 {case}: the tinygemm yardstick computes another function: {lib_err} > {tol}")
        if per_request and gs == 128:
            for key, value in (("kernel", ms), ("tinygemm", library_ms), ("cublas_bf16", cublas_ms),
                               ("bound", bound[0])):
                sums.setdefault(m, {}).setdefault(key, 0.0)
                sums[m][key] += per_request * value
        if m == 256 and gs == 128:  # every split the plan could take, in turns (the plan's cost model is fitted to these)
            nw = plan[0]
            tiles = -(-m // nw) * -(-n_dim // im.TILE_N)
            fns = {}
            for splits in range(1, im.MAX_SPLITS[nw] + 1):
                grid = min(tiles, capacity(nw, splits) // splits) * splits
                fns[splits] = (lambda splits=splits, grid=grid: _int4_with_plan(x, p, nw, splits, grid))
            split_turns = in_turns(fns)
            splits_ms[label] = {sp: statistics.mean(v) for sp, v in split_turns.items()}
            log(f"[kernels] int4 M={m} {label} by K split (blocks of each in clusters of it): " + " | ".join(
                f"{sp} {t:.4f} ms" for sp, t in splits_ms[label].items()))
        int4.append(dict(case=case, m=m, k=k_dim, n=n_dim, group_size=gs, plan=list(plan), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=lib_err,
                         cublas_bf16_ms=cublas_ms, turns_ms=turns, bound_ms=bound[0], bound_by=bound[1],
                         bound_share=bound[0] / ms, launches_per_request=per_request))
        del lw, ltable, lib_out, wb
    for m, row in sums.items():
        log(f"[kernels] int4 a request's {sum(r for *_, r in T5_SHAPES)} products at M {m} (24 layers × 4 qkvo, "
            f"2 wi, 1 wo): kernel {row['kernel']:.2f} ms, tinygemm {row['tinygemm']:.2f}, cuBLAS bf16 "
            f"{row['cublas_bf16']:.2f}, bound {row['bound']:.2f} ({100 * row['bound'] / row['kernel']:.1f}% of it)")
    # one-hot rows pick single weights: the output is the dequantized weight,
    # bf16(f32(q) · s) grouped, bf16(q · s) per channel, bit for bit
    for gs in (128, None):
        w = torch.randn((4096, 4096), generator=g, device=dev) / 64
        p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
        x = torch.zeros((256, 4096), dtype=torch.bfloat16, device=dev)
        x[torch.arange(256, device=dev), (torch.arange(256, device=dev) * 37) % 4096] = 1
        out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
        ref = im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"])
        differ = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
        log(f"[kernels] int4 one-hot rows, {'g128' if gs else 'per channel'}: {differ} of {out.numel()} values "
            "differ from the plain version's bits (must be 0)")
        if differ:
            raise AssertionError(f"int4 one-hot rows ({gs}): {differ} values differ bit for bit")
    # what the TPU wrapper also takes (it pads M and N): one row, 17 rows, a
    # ragged N; and f32 activations (CUDA-core f32 FMAs, no TF32), held to
    # 1e-5 of max|ref|
    for label, m, k_dim, n_dim, dtype in (("M1_4096x4096_g128", 1, 4096, 4096, torch.bfloat16),
                                          ("M17_4096x4096_g128", 17, 4096, 4096, torch.bfloat16),
                                          ("M256_4096xN200_g128", 256, 4096, 200, torch.bfloat16),
                                          ("f32_M256_4096x4096_g128", 256, 4096, 4096, torch.float32)):
        w = torch.randn((k_dim, n_dim), generator=g, device=dev) / k_dim ** 0.5
        p = quantize_dense({"kernel": w}, bits=4, group_size=128, pack=True)
        x = torch.randn((m, k_dim), generator=g, device=dev).to(dtype)
        out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
        ref = im.int4_matmul_reference(x.float(), p["kernel_q4"], p["kernel_scale"])
        err = (out.float() - ref).abs().max().item()
        tol = (INT4_REL_TOL if dtype == torch.bfloat16 else 1e-5) * ref.abs().max().item()
        ms = time_ms_queued(lambda: im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"]))
        plain_ms = time_ms(lambda: im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"]))
        gflop = 2 * m * k_dim * n_dim / 1e9
        xb = x.element_size()
        bound = bound_ms(gflop * 1e9 if dtype == torch.bfloat16 else 0,
                         xb * m * (k_dim + n_dim) + p["kernel_q4"].numel() + p["kernel_scale"].numel() * 4)
        if dtype == torch.float32:  # f32 FMAs on the CUDA cores: 67 TFLOP/s
            bound = max(bound, (gflop * 1e9 / PEAK_F32_FLOPS * 1e3, "operations"))
        log(f"[kernels] int4 {label}: {tuple(out.shape)} {out.dtype}, max|Δ| {err:.3e} (tol {tol:.3e}) | "
            f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]})")
        if not (err <= tol and out.dtype == dtype and out.shape == (m, n_dim)):
            raise AssertionError(f"int4 {label} disagrees with its plain version: {err} > {tol}")
        int4.append(dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound[0], bound_by=bound[1]))
    return {"int4_matmul": int4, "int4_matmul_request_ms": sums, "int4_matmul_splits_ms": splits_ms,
            "int4_matmul_clusters": clusters}


def _int4_with_plan(x, p, nw, splits, grid):
    """Kernel B on bf16 x with a given (rows a tile, splits, grid), as the
    wrapper launches it with its own plan (N a multiple of 16)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import _build
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im

    m, k = x.shape
    n = p["kernel_q4"].shape[1]
    scale = p["kernel_scale"]
    gs = k // scale.shape[0] if scale.dim() == 2 else 0
    out = torch.empty((-(-m // nw) * nw, n), dtype=x.dtype, device=x.device)
    err = _build.load("int4_matmul", im._SIGNATURES).fgt_int4_matmul(
        x.data_ptr(), p["kernel_q4"].data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, n, k, gs, 0, nw, splits,
        grid, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fgt_int4_matmul", err)
    return out



def phase_kernels_bare_dot():
    """The bare-dot probe #13 in its three modes at the probe's shapes (64
    steps of (1024, 128)·(128, 1024)) against its plain version: the int8
    modes bit for bit, bf16 within one bf16 step of max|out|. The yardstick
    for "bf16" is torch.bmm on the same blocks, timed in turns with the
    kernel and with a zero fill of out's size (what its 134 MB alone take to
    write); no PyTorch call computes the int8 modes (torch._int_mm has no
    batched form, and none quantizes inside), which are timed alone on the
    same clock (CUDA events behind a sleep kernel)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import bare_dot as bd
    from flux_generator_tpu_torch.scripts.prof_attn_int8 import BM, BN, K, dot_inputs

    dev = torch.device("cuda")
    steps = 64
    cases = {}
    for mode in bd.MODES:
        a, b = dot_inputs(mode, steps, dev, seed=13)
        out = bd.bare_dot(a, b, mode)
        ref = bd.bare_dot_reference(a, b, mode)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 0.0 if mode != "bf16" else 2.0 ** -8 * ref.float().abs().max().item()
        plain_ms = time_ms(lambda: bd.bare_dot_reference(a, b, mode), iters=5, warmup=1)
        library_ms = lib_turns = zero_turns = None
        if mode == "bf16":
            # yardsticks in turns: torch.bmm on the same blocks, and the output's
            # bytes alone (a zero fill of a tensor of out's size)
            a3, b3 = a.view(steps, BM, K), b.view(K, steps, BN).permute(1, 0, 2)
            lib_err = (torch.bmm(a3, b3).reshape(steps * BM, BN).float() - ref.float()).abs().max().item()
            turns = in_turns({"kernel": lambda: bd.bare_dot(a, b, mode), "bmm": lambda: torch.bmm(a3, b3),
                              "zero": lambda: out.zero_()})
            kernel_turns, lib_turns, zero_turns = turns["kernel"], turns["bmm"], turns["zero"]
            library_ms = statistics.mean(lib_turns)
        else:
            kernel_turns = [time_ms_queued(lambda: bd.bare_dot(a, b, mode))]
        ms = statistics.mean(kernel_turns)
        flop = 2 * BM * K * BN * steps
        # a and b once, out (bf16) once
        nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() + 2 * steps * BM * BN
        bound = bound_ms(flop, nbytes, PEAK_BF16_FLOPS if mode != "int8" else PEAK_INT8_OPS)
        log(f"[kernels-bare-dot] {mode} steps={steps}: max|Δ| {err:.3e} (tol {tol:.3e}) | kernel "
            + " ".join(f"{t:.4f}" for t in kernel_turns)
            + f" ms ({flop / ms / 1e9:.1f} TFLOP/s-eff, {nbytes / ms / 1e6:.1f} GB/s, {100 * bound[0] / ms:.1f}% "
            f"of its bound) | plain {plain_ms:.4f} ms | "
            + (("torch.bmm in turns " + " ".join(f"{t:.4f}" for t in lib_turns) + f" ms (max|Δ| {lib_err:.3e}), "
                "out's bytes alone (zero fill) " + " ".join(f"{t:.4f}" for t in zero_turns) + " ms")
               if lib_turns else "library none")
            + f" | bound {bound[0]:.4f} ms ({bound[1]})")
        if not err <= tol:
            raise AssertionError(f"bare dot {mode} disagrees with its plain version: {err} > {tol}")
        cases[mode] = dict(case=f"{mode}_steps{steps}", max_abs_err=err, ms=ms, ms_in_turns=kernel_turns,
                           plain_ms=plain_ms, library_ms=library_ms, library_ms_in_turns=lib_turns,
                           zero_fill_ms_in_turns=zero_turns,
                           bound_ms=bound[0], bound_by=bound[1], bound_share=bound[0] / ms)
        del a, b, out, ref
    return {"bare_dot": cases}


def _plain_by_heads(fn, q, k, v, cos, sin, chunk: int = 2):
    """fn's (out, lse) over the heads `chunk` at a time: the plain attention
    versions hold (B, H, L, L) logits, 2.2 GB a head in f64 at L 16640."""
    import torch

    b, l, h, d = q.shape
    outs, lses = [], []
    for h0 in range(0, h, chunk):
        o, ls = fn(q[:, :, h0:h0 + chunk], k[:, :, h0:h0 + chunk], v[:, :, h0:h0 + chunk], cos, sin)
        outs.append(o)
        lses.append(ls.reshape(b, -1, l))
    return torch.cat(outs, 2), torch.cat(lses, 1).reshape(b * h, l)


def phase_kernels_flash_streamed():
    """Kernel A as `flash_attention_streamed` runs it (the JAX streamed path,
    its int8 tiers at any length): "", "qk" and "full" in groups of 1024
    keys at the 2048² geometry (L 16640, 24 heads of 128, RoPE of 16640
    positions), each timed and held to its plain version (run two heads at a
    time); the streamed "full" also at L 1280 in groups of 64 and 1024; the
    one-shot "full" as the control it must tell apart; SDPA's bf16 forward at
    L 16640 for scale. Then the probe's entry point, prof_attn_int8.run
    (8 steps), whose launches are this slice's probe path."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import bare_dot as bd
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.scripts import prof_attn_int8 as probe

    dev = torch.device("cuda")
    failures, cases = [], {}
    q, k, v, cos, sin = probe.flash_inputs(dev, seed=16)
    b, l, h, d = q.shape
    half = 2 * l * l * d * h
    io_bytes = 4 * q.numel() * 2 + 2 * cos.numel() * 2 + l * h * 4
    plain = {"": lambda *a: fa.flash_attention_reference(*a),
             "qk": lambda *a: fa.flash_attention_reference(*a, int8="qk"),
             "full": lambda *a: fa.streamed_full_reference(*a, blk_k=1024)}
    # the bf16 mode's stages, and SDPA's forward on the same rotated q/k
    q_rot, k_rot = fa.rope_rotate(q, k, cos, sin)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q_rot, k_rot, v))
    for tier in ("", "qk", "full"):
        name = {"": "bf16", "qk": "qk", "full": "full_streamed"}[tier]
        out, lse = fa.flash_attention_streamed(q, k, v, cos, sin, int8=tier, blk_k=1024)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_lse = _plain_by_heads(plain[tier], q, k, v, cos, sin)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        err = (out.float() - ref.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        if tier:
            ms = time_ms(lambda: fa.flash_attention_streamed(q, k, v, cos, sin, int8=tier, blk_k=1024),
                         iters=3, warmup=1)
        else:  # in turns with SDPA's forward; the pre-pass and the kernel alone
            turns = in_turns({"route": lambda: fa.flash_attention_streamed(q, k, v, cos, sin, blk_k=1024),
                              "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)},
                             iters=5)
            ms = statistics.mean(turns["route"])
            kernel_ms = time_ms_queued(lambda: fa.flash_attention_sm90(q_rot, k_rot, v), iters=5)
            rope_ms = time_ms_queued(lambda: fa.rope_rotate(q, k, cos, sin), iters=5)
        # the function's work: the kernel's second Q·Kᵀ sweep in "full" is its
        # design's, not the function's, and stays out of the bound
        parts = {"": [(2 * half, PEAK_BF16_FLOPS)], "qk": [(half, PEAK_INT8_OPS), (half, PEAK_BF16_FLOPS)],
                 "full": [(2 * half, PEAK_INT8_OPS)]}[tier]
        bound = bound_ms_parts(parts, io_bytes)
        rec = dict(case=f"L{l}_h{h}_rope_blk1024", max_abs_err=err, out_rel_l2=rel, lse_max_abs_err=err_lse,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=None)
        if not tier:
            rope_bound = bound_ms(0, 4 * q.numel() * 2 + 2 * cos.numel() * 2)
            rec.update(turns_ms=turns, library_ms=statistics.mean(turns["sdpa"]), kernel_ms=kernel_ms,
                       rope_ms=rope_ms, rope_bound_ms=rope_bound[0], tflops=2 * half / kernel_ms / 1e9,
                       bound_share=bound[0] / kernel_ms)
        if tier == "full":
            tol_out, tol_lse = INT8_ATTN_TOL["full"]
            ctrl, ctrl_lse = _plain_by_heads(lambda *a: fa.flash_attention_reference(*a, int8="full"),
                                             q[:, :, :2], k[:, :, :2], v[:, :, :2], cos, sin)
            ref2 = ref[:, :, :2].float()
            rec["control_one_shot_out_rel_l2"] = ((ctrl.float() - ref2).norm() / ref2.norm()).item()
            ok = rel <= tol_out and err_lse <= tol_lse and rec["control_one_shot_out_rel_l2"] > tol_out
            note = (f"out rel-L2 {rel:.3e} (tol {tol_out}), lse max|Δ| {err_lse:.3e} (tol {tol_lse}), "
                    f"one-shot control {rec['control_one_shot_out_rel_l2']:.3e} (must exceed {tol_out})")
        elif tier == "qk":
            tol_out, tol_lse = INT8_ATTN_TOL["qk"]
            ok = rel <= tol_out and err_lse <= tol_lse
            note = f"out rel-L2 {rel:.3e} (tol {tol_out}), lse max|Δ| {err_lse:.3e} (tol {tol_lse})"
        else:
            # held below, once the "qk" control exists
            tol_out, tol_lse = FLASH_LONG_TOL
            ok = rel <= tol_out and err_lse <= tol_lse
            note = f"out rel-L2 {rel:.3e} (tol {tol_out}), lse max|Δ| {err_lse:.3e} (tol {tol_lse})"
            bf16_ref2, bf16_lse2 = ref[:, :, :2].float(), ref_lse.reshape(b, h, l)[:, :2].reshape(-1, l)
        if tier == "qk":
            qk_out2, qk_lse2 = out[:, :, :2].float(), lse.reshape(b, h, l)[:, :2].reshape(-1, l)
        log(f"[kernels-flash-streamed] {name} L={l} H={h}: {note} | kernel {ms:.4f} ms "
            f"({2 * half / ms / 1e9:.1f} TFLOP/s-eff) | plain (2 heads at a time) {plain_ms:.1f} ms | "
            f"bound {bound[0]:.4f} ms ({bound[1]})")
        if not tier:
            log(f"[kernels-flash-streamed] bf16 L={l}: route in turns {' '.join(f'{t:.4f}' for t in turns['route'])}"
                f" ms, SDPA fwd {' '.join(f'{t:.4f}' for t in turns['sdpa'])} ms | attention kernel alone "
                f"{kernel_ms:.4f} ms ({2 * half / kernel_ms / 1e9:.1f} TFLOP/s, {100 * bound[0] / kernel_ms:.1f}% "
                f"of the bound) | pre-pass alone {rope_ms:.4f} ms (bound {rope_bound[0]:.4f} ms, bytes)")
        if not ok:
            failures.append(f"{name} L {l}: {note}")
        cases[name] = rec
        del out, lse, ref, ref_lse
    # the bf16 tier's controls, on its two checked heads: each must fail the
    # check that the kernel passed
    qr = fa._rope_f32(q[:, :, :2], cos, sin).to(q.dtype)
    kr = fa._rope_f32(k[:, :, :2], cos, sin).to(q.dtype)
    keep = l // 1024 * 1024
    dropped, dropped_lse = fa.flash_attention_reference(qr, kr[:, :keep], v[:, :keep, :2])
    del qr, kr
    tol_out, tol_lse = FLASH_LONG_TOL
    controls = {"qk_tier_output": (qk_out2, qk_lse2), f"last_{l - keep}_keys_dropped": (dropped.float(), dropped_lse)}
    for cname, (c_out, c_lse) in controls.items():
        c_rel = ((c_out - bf16_ref2).norm() / bf16_ref2.norm()).item()
        c_lse_err = (c_lse - bf16_lse2).abs().max().item()
        cases["bf16"][f"control_{cname}"] = dict(out_rel_l2=c_rel, lse_max_abs_err=c_lse_err)
        log(f"[kernels-flash-streamed] bf16 L={l} control {cname}: out rel-L2 {c_rel:.3e}, lse max|Δ| "
            f"{c_lse_err:.3e} (must exceed {tol_out} or {tol_lse})")
        if c_rel <= tol_out and c_lse_err <= tol_lse:
            failures.append(f"bf16 L {l}: the control {cname} passes ({c_rel}, {c_lse_err})")
    del controls, dropped, dropped_lse, qk_out2, qk_lse2, bf16_ref2, bf16_lse2
    sdpa_ms = cases["bf16"]["library_ms"]  # the mean of its turns with the bf16 route
    log(f"[kernels-flash-streamed] SDPA bf16 forward L={l} H={h} (yardstick; CUDA events behind a sleep, in "
        f"turns with the bf16 route): {sdpa_ms:.4f} ms ({2 * half / sdpa_ms / 1e9:.1f} TFLOP/s)")
    for name in cases:
        cases[name]["sdpa_bf16_ms"] = sdpa_ms
    del q, k, v, q_rot, k_rot, qs, ks, vs

    short = []
    for length, blk in ((1280, 64), (1280, 1024)):
        g = torch.Generator(device=dev).manual_seed(17)
        q, k, v = (torch.randn((1, length, 24, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        cos, sin = _flux_rope_tables(length)
        out, lse = fa.flash_attention_streamed(q, k, v, cos, sin, int8="full", blk_k=blk)
        ref, ref_lse = fa.streamed_full_reference(q, k, v, cos, sin, blk_k=blk)
        ctrl, _ = fa.flash_attention_reference(q, k, v, cos, sin, int8="full")
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        err_lse = (lse - ref_lse).abs().max().item()
        ctrl_rel = ((ctrl.float() - ref.float()).norm() / ref.float().norm()).item()
        ms = time_ms(lambda: fa.flash_attention_streamed(q, k, v, cos, sin, int8="full", blk_k=blk))
        tol_out, tol_lse = INT8_ATTN_TOL["full"]
        log(f"[kernels-flash-streamed] full_streamed L={length} blk_k={blk}: out rel-L2 {rel:.3e} "
            f"(tol {tol_out}), lse max|Δ| {err_lse:.3e} | one-shot control {ctrl_rel:.3e} | kernel {ms:.4f} ms")
        if not (rel <= tol_out and err_lse <= tol_lse):
            failures.append(f"full_streamed L {length} blk {blk}: rel {rel}, lse {err_lse}")
        if not ctrl_rel > tol_out:
            failures.append(f"full_streamed L {length} blk {blk}: the one-shot control passes ({ctrl_rel})")
        short.append(dict(case=f"L{length}_blk{blk}", out_rel_l2=rel, lse_max_abs_err=err_lse,
                          control_one_shot_out_rel_l2=ctrl_rel, ms=ms))
    cases["full_streamed_short"] = short

    # the probe's entry point: the path that runs #13 and A's streamed "full"
    bd.launches.update({m: 0 for m in bd.MODES})
    fa.int8_launches["full_streamed"] = 0
    t0 = time.perf_counter()
    run = probe.run(steps=8)
    launches = {"bare_dot": dict(bd.launches), "flash_attention_int8_full_streamed":
                fa.int8_launches["full_streamed"]}
    log(f"[kernels-flash-streamed] prof_attn_int8.run(steps=8): {time.perf_counter() - t0:.2f} s | launches "
        f"{launches} | dots ok {[m for m, r in run['dots'].items() if r['ok']]}")
    if not all(r["ok"] for r in run["dots"].values()):
        failures.append(f"prof_attn_int8 bare dots: {run['dots']}")
    if failures:
        raise AssertionError("streamed flash kernels: " + "; ".join(failures))
    return {"flash_attention_streamed": cases, "prof_attn_int8": dict(run=run, launches=launches)}



class _FixedTokens:
    """A tokenizer that returns one fixed (1, n) token list."""

    def __init__(self, tokens):
        self.tokens = tokens

    def encode(self, text):
        return self.tokens


def _tokenizers():
    from flux_generator_tpu_torch.io.registry import FLUX_T5_MAX_LENGTH
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer

    t5 = load_t5_tokenizer(ROOT / "tests/assets/spiece/t5_like.model",
                           max_length=FLUX_T5_MAX_LENGTH["flux-schnell"])
    try:
        clip = load_clip_tokenizer(ROOT / "tests/assets/clip_tokenizer/vocab.json",
                                   ROOT / "tests/assets/clip_tokenizer/merges.txt")
    except ImportError:
        # the fixed (1, 77) array the JAX bench feeds (bench.py:398-399)
        return t5, _FixedTokens([[1] * 77]), "fixed (1, 77) token array (no regex module)"
    return t5, clip, "CLIP BPE test asset (tests/assets/clip_tokenizer)"


def phase_main():
    """Returns the record, the pipeline (main-w8a8 runs on it) and the final
    latent of each seed."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = FluxPipeline.random_init("flux-schnell", dtype=torch.bfloat16, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # T5 first: its int4 copy is small, so the peak is bf16 flow + int8 flow
    pipe.params["t5"] = quantize_tree(pipe.params["t5"], bits=4, group_size=128, pack=True)
    pipe.params["flow"] = quantize_tree(pipe.params["flow"])  # int8 per channel
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quant_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"[main] random init {init_s:.2f} s, quantize {quant_s:.2f} s | setup peak "
        f"{setup_peak:.2f} GiB, resident {resident:.2f} GiB")

    pipe.t5_tokenizer, pipe.clip_tokenizer, clip_source = _tokenizers()
    log(f"[main] T5 tokens: SentencePiece test asset, padded to 256 | CLIP tokens: {clip_source}")

    latent = (SIZE // 8, SIZE // 8)
    t0 = time.perf_counter()
    pipe.generate_images("warm-up", num_steps=STEPS, latent_size=latent, seed=0, as_uint8=True)
    torch.cuda.synchronize()
    log(f"[main] warm-up request {time.perf_counter() - t0:.3f} s (not counted)")

    fa.launches = fa.rope_launches = 0
    im.launches = 0
    requests, images, latents = [], [], {}
    for seed, prompt in PROMPTS:
        torch.cuda.reset_peak_memory_stats()
        fa0, im0, rope0 = fa.launches, im.launches, fa.rope_launches
        trace = {}
        t0 = time.perf_counter()
        img = pipe.generate_images(prompt, num_steps=STEPS, latent_size=latent, seed=seed,
                                   as_uint8=True, trace=trace)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        flash_n, int4_n, rope_n = fa.launches - fa0, im.launches - im0, fa.rope_launches - rope0
        finite = bool(torch.isfinite(trace["latent"]).all())
        rec = dict(seed=seed, latency_s=latency, conditioning_s=trace["conditioning_s"],
                   denoise_s=trace["denoise_s"], decode_s=trace["decode_s"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=flash_n,
                   flash_rope_launches=rope_n, int4_launches=int4_n, shape=list(img.shape), dtype=str(img.dtype),
                   latent_finite=finite)
        log(f"[main] request seed={seed}: {latency:.4f} s (conditioning {rec['conditioning_s']:.4f}"
            f" + denoise {rec['denoise_s']:.4f} + decode {rec['decode_s']:.4f}) | peak "
            f"{rec['peak_gib']:.2f} GiB | launches flash {flash_n} (RoPE pre-pass {rope_n}) int4 {int4_n} | "
            f"{tuple(img.shape)} {img.dtype} | latent finite {finite}")
        if tuple(img.shape) != (1, SIZE, SIZE, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"image {tuple(img.shape)} {img.dtype}")
        if not finite:
            raise AssertionError("final latent is not finite")
        if flash_n != 57 * STEPS or int4_n != 24 * 7:
            raise AssertionError(f"launch counts flash {flash_n} (want {57 * STEPS}), "
                                 f"int4 {int4_n} (want {24 * 7})")
        if rope_n != flash_n:  # every attention call of the flow rotates with its tables
            raise AssertionError(f"RoPE pre-pass launches {rope_n}, want one an attention call ({flash_n})")
        requests.append(rec)
        images.append(img)
        latents[seed] = trace["latent"]
    if any(torch.equal(images[0], other) for other in images[1:]):
        raise AssertionError("requests with different seeds gave identical images")
    record = dict(init_s=init_s, quantize_s=quant_s, setup_peak_gib=setup_peak,
                  resident_gib=resident, clip_tokens=clip_source, requests=requests,
                  launches={"flash_attention": fa.launches, "flash_attention_rope": fa.rope_launches,
                            "int4_matmul": im.launches})
    record["conditioning_profile"] = _profile_conditioning(pipe)
    return record, pipe, latents


def _profile_conditioning(pipe, reps: int = 5):
    """A request's conditioning alone (tokenize, T5-XXL on int4 weights, CLIP-L)
    under torch.profiler: its wall time, the device's busy share and the
    device time by kernel group (B's among them), each a conditioning."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompt = PROMPTS[0][1]
    for _ in range(2):
        pipe.prepare_conditioning(1, *pipe.tokenize(prompt))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pipe.prepare_conditioning(1, *pipe.tokenize(prompt))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return _profile_record(prof, reps, wall_ms, "main conditioning profile", "conditioning",
                           "tokenize + T5-XXL + CLIP-L")


def _launch_counts():
    """Every kernel counter the Flux paths touch."""
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm

    return {"flash_attention": fa.launches, "flash_attention_int8_qk": fa.int8_launches["qk"],
            "flash_attention_int8_full": fa.int8_launches["full"], "int4_matmul": im.launches,
            "w8a8_matmul": wm.launches, "w8a8_quantize_rows": wm.quantize_launches}


def _reset_launch_counts():
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm

    fa.launches = im.launches = wm.launches = wm.quantize_launches = fa.rope_launches = 0
    fa.int8_launches.update(qk=0, full=0, full_streamed=0)


def _flux_request(pipe, seed: int, prompt: str):
    """One 512², 4-step request → (uint8 image, trace, latency s)."""
    import torch

    trace = {}
    t0 = time.perf_counter()
    img = pipe.generate_images(prompt, num_steps=STEPS, latent_size=(SIZE // 8, SIZE // 8), seed=seed,
                               as_uint8=True, trace=trace)
    torch.cuda.synchronize()
    return img, trace, time.perf_counter() - t0


def phase_main_w8a8(pipe, weight_only_latents):
    """The W8A8 serving configuration on main's pipeline as main built it
    (int8 flow, int4 T5-XXL, bf16 CLIP): three requests each on the "fused" and "rows"
    routes, then one "fused" request each with int8 attention "qk" and
    "full", with the seeds and prompts of main. Per request: the image, a
    finite latent, the exact launch counts (a step runs 230 int8-activation
    denses on G or H: 8 in each of the 19 double blocks, linear1 and linear2
    in each of the 38 single blocks, txt_in and the final linear; the 79
    with one activation row, the modulations and the embedders' out layers,
    take the "ops" formulation), and the final latent's rel-L2 against the
    weight-only latent of its seed. Then weight-only and "fused" requests in
    turns for their latencies on one card, and one of each under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    denses = (8 * pipe.flow_cfg.depth + 2 * pipe.flow_cfg.depth_single_blocks + 2) * STEPS
    attn = (pipe.flow_cfg.depth + pipe.flow_cfg.depth_single_blocks) * STEPS
    runs = [("fused", "", PROMPTS), ("rows", "", PROMPTS), ("fused", "qk", PROMPTS[:1]),
            ("fused", "full", PROMPTS[:1])]
    for w8a8 in ("fused", "rows"):
        pipe.w8a8, pipe.attn_int8 = w8a8, ""
        t0 = time.perf_counter()
        _flux_request(pipe, 0, "warm-up")
        log(f"[main-w8a8] warm-up request ({w8a8}) {time.perf_counter() - t0:.3f} s (not counted)")

    _reset_launch_counts()
    requests, failures = [], []
    for w8a8, attn_int8, prompts in runs:
        pipe.w8a8, pipe.attn_int8 = w8a8, attn_int8
        images = []
        for seed, prompt in prompts:
            torch.cuda.reset_peak_memory_stats()
            c0 = _launch_counts()
            img, trace, latency = _flux_request(pipe, seed, prompt)
            n = {key: v - c0[key] for key, v in _launch_counts().items()}
            want = {"flash_attention": attn, "flash_attention_int8_qk": attn if attn_int8 == "qk" else 0,
                    "flash_attention_int8_full": attn if attn_int8 == "full" else 0,
                    "int4_matmul": 24 * 7, "w8a8_matmul": denses if w8a8 == "fused" else 0,
                    "w8a8_quantize_rows": denses if w8a8 == "rows" else 0}
            lat, ref = trace["latent"].float(), weight_only_latents[seed].float()
            rel = ((lat - ref).norm() / ref.norm()).item()
            finite = bool(torch.isfinite(lat).all())
            rec = dict(route=w8a8, attn_int8=attn_int8, seed=seed, latency_s=latency,
                       conditioning_s=trace["conditioning_s"], denoise_s=trace["denoise_s"],
                       decode_s=trace["decode_s"], peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       launches=n, latent_rel_l2_vs_weight_only=rel, shape=list(img.shape),
                       dtype=str(img.dtype), latent_finite=finite)
            log(f"[main-w8a8] {w8a8}{'+' + attn_int8 if attn_int8 else ''} seed={seed}: {latency:.4f} s "
                f"(conditioning {rec['conditioning_s']:.4f} + denoise {rec['denoise_s']:.4f} + decode "
                f"{rec['decode_s']:.4f}) | peak {rec['peak_gib']:.2f} GiB | latent rel-L2 vs weight-only "
                f"{rel:.4e} (tol {W8A8_LATENT_REL_TOL}) | launches G {n['w8a8_matmul']} H "
                f"{n['w8a8_quantize_rows']} A {n['flash_attention']} (int8 qk "
                f"{n['flash_attention_int8_qk']}, full {n['flash_attention_int8_full']}) B "
                f"{n['int4_matmul']} | {tuple(img.shape)} {img.dtype} | latent finite {finite}")
            if tuple(img.shape) != (1, SIZE, SIZE, 3) or img.dtype != torch.uint8 or not finite:
                failures.append(f"{w8a8}/{attn_int8} seed {seed}: image {tuple(img.shape)} {img.dtype}, "
                                f"latent finite {finite}")
            if n != want:
                failures.append(f"{w8a8}/{attn_int8} seed {seed}: launches {n}, want {want}")
            if not rel <= W8A8_LATENT_REL_TOL:
                failures.append(f"{w8a8}/{attn_int8} seed {seed}: latent rel-L2 {rel}")
            requests.append(rec)
            images.append(img)
        if any(torch.equal(images[0], other) for other in images[1:]):
            failures.append(f"{w8a8}/{attn_int8}: different seeds gave identical images")
    launches = _launch_counts()
    log(f"[main-w8a8] launches over the {len(requests)} requests: {launches}")

    # weight-only against "fused" in turns (W F F W, twice) on this card
    turns = {None: [], "fused": []}
    for w8a8 in (None, "fused", "fused", None) * 2:
        pipe.w8a8, pipe.attn_int8 = w8a8, ""
        turns[w8a8].append(_flux_request(pipe, 1, PROMPTS[0][1])[2])
    ab = {("weight_only" if k is None else k): sorted(v) for k, v in turns.items()}
    log("[main-w8a8] in turns, seed 1: " + " | ".join(
        f"{k} " + " ".join(f"{x:.4f}" for x in v) + f" s (median {statistics.median(v):.4f})"
        for k, v in ab.items()))

    profiles = {}
    for label, w8a8 in (("weight_only", None), ("fused", "fused")):
        pipe.w8a8, pipe.attn_int8 = w8a8, ""
        _flux_request(pipe, 9, "a profiled request")  # same shapes, warm
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, latency = _flux_request(pipe, 9, "a profiled request")
        profiles[label] = _profile_record(prof, 1, latency * 1e3, f"main-w8a8 profile {label}",
                                          "request", "512², 4 steps")
    pipe.w8a8, pipe.attn_int8 = None, ""
    if failures:
        raise AssertionError("W8A8 requests failed: " + "; ".join(failures))
    return dict(requests=requests, launches=launches, profiles=profiles, latency_in_turns_s=ab,
                g_or_h_per_request=denses, attention_per_request=attn)


def _timed_request_2048(pipe, generator_steps, latent_hw, first_key: str):
    """Drive one request through a generator method and decode_u8: the
    first yield (its conditioning, and for img2img the encode before it),
    the denoise steps and the uint8 decode, each ended by a synchronize →
    (uint8 image, final latent, phase seconds)."""
    import torch

    split = {}
    t0 = time.perf_counter()
    cond = next(generator_steps)
    torch.cuda.synchronize()
    split[first_key] = time.perf_counter() - t0
    t1 = time.perf_counter()
    x_t = cond[0]
    for x_t in generator_steps:
        pass
    torch.cuda.synchronize()
    split["denoise_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    img = pipe.decode_u8(x_t, latent_hw)
    torch.cuda.synchronize()
    split["decode_s"] = time.perf_counter() - t1
    split["wall_s"] = time.perf_counter() - t0
    return img, x_t, split


def phase_main_2048(pipe):
    """The server's generator protocol at 2048² on main's full-width
    pipeline (weight-only: int8 flow, int4 T5-XXL): one 4-step text-to-image
    request through generate_latents then decode_u8 (latent 256², L 16640,
    tiled decode in 9 tiles), then img2img through
    generate_latents_from_image on that image at strength 0.5 (tiled encode
    in 9 tiles, steps 2 and 3 of 4). Per request: the phase split, peak
    memory, exact launch counts (228 A + 168 B; 114 A + 168 B), the final
    latent and the float decode finite; the encode alone timed once; the
    text-to-image request again under torch.profiler (busy share, kernel
    groups). Then at 512² generate_images_fused against generate_images(...,
    as_uint8=True), byte for byte, with no host synchronisation inside the
    fused call (torch.cuda sync debug mode)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im

    pipe.w8a8, pipe.attn_int8 = None, ""
    size, latent = 2048, (256, 256)
    blocks = pipe.flow_cfg.depth + pipe.flow_cfg.depth_single_blocks
    seed, prompt = 21, "an aerial photograph of a harbour town at golden hour"
    failures, requests = [], {}

    def check(tag, img, x_t, split, want_a):
        n = {"flash_attention": fa.launches, "int4_matmul": im.launches}
        finite = bool(torch.isfinite(x_t).all())
        pixels = pipe.decode(x_t, latent)  # untimed float decode: every pixel finite
        pixels_finite = bool(torch.isfinite(pixels).all())
        same_u8 = torch.equal((torch.clamp(pixels, 0, 1).float() * 255).to(torch.uint8), img)
        del pixels
        rec = dict(split, peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=n,
                   shape=list(img.shape), dtype=str(img.dtype), latent_finite=finite,
                   pixels_finite=pixels_finite, u8_matches_float_decode=same_u8)
        log(f"[main-2048] {tag}: wall {split['wall_s']:.4f} s ("
            + " + ".join(f"{k[:-2]} {v:.4f}" for k, v in split.items() if k != "wall_s")
            + f") | peak {rec['peak_gib']:.2f} GiB | launches A {n['flash_attention']} B {n['int4_matmul']} "
            f"(want {want_a}, 168) | {tuple(img.shape)} {img.dtype} | latent finite {finite}, float pixels "
            f"finite {pixels_finite}, uint8 = float decode quantized {same_u8}")
        if tuple(img.shape) != (1, size, size, 3) or img.dtype != torch.uint8:
            failures.append(f"{tag}: image {tuple(img.shape)} {img.dtype}")
        if not (finite and pixels_finite and same_u8):
            failures.append(f"{tag}: latent finite {finite}, pixels finite {pixels_finite}, u8 {same_u8}")
        if n != {"flash_attention": want_a, "int4_matmul": 24 * 7}:
            failures.append(f"{tag}: launches {n}, want A {want_a} B 168")
        requests[tag] = rec

    fa.launches = im.launches = 0
    torch.cuda.reset_peak_memory_stats()
    img, x_t, split = _timed_request_2048(
        pipe, pipe.generate_latents(prompt, num_steps=STEPS, latent_size=latent, seed=seed), latent,
        "conditioning_s")
    check("txt2img 2048² 4 steps", img, x_t, split, blocks * STEPS)

    image = img.float() / 127.5 - 1  # the request's image in [-1, 1]
    strength = 0.5
    start = min(int(round((1 - strength) * STEPS)), STEPS - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe._encode_image(image.to(pipe.dtype))
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    fa.launches = im.launches = 0
    torch.cuda.reset_peak_memory_stats()
    img2, x_t2, split2 = _timed_request_2048(
        pipe, pipe.generate_latents_from_image(image, prompt, strength=strength, num_steps=STEPS, seed=seed + 1),
        latent, "encode_conditioning_s")
    split2["encode_alone_s"] = encode_s
    check(f"img2img 2048² strength {strength} (steps {start}..{STEPS - 1})", img2, x_t2, split2,
          blocks * (STEPS - start))
    if torch.equal(img, img2):
        failures.append("img2img returned its input image")
    del image, img2, x_t2

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, psplit = _timed_request_2048(
            pipe, pipe.generate_latents(prompt, num_steps=STEPS, latent_size=latent, seed=seed), latent,
            "conditioning_s")
    profile_rec = _profile_record(prof, 1, psplit["wall_s"] * 1e3, "main-2048 profile", "request",
                                  "2048², 4 steps, txt2img")
    del prof

    # the one-call request against generate_images, at 512²
    latent512 = (SIZE // 8, SIZE // 8)
    want = pipe.generate_images(PROMPTS[0][1], num_steps=STEPS, latent_size=latent512, seed=PROMPTS[0][0],
                                as_uint8=True)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            got = pipe.generate_images_fused(PROMPTS[0][1], num_steps=STEPS, latent_size=latent512,
                                             seed=PROMPTS[0][0])
            enqueue_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    # the sync debug mode's warning for each synchronizing call (not its
    # notice that it is a prototype)
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]
    equal = torch.equal(got, want)
    log(f"[main-2048] generate_images_fused 512² seed {PROMPTS[0][0]}: equal to generate_images(as_uint8) "
        f"byte for byte {equal} | host synchronisations inside the call {len(syncs)} | enqueued in "
        f"{enqueue_s:.4f} s, done at {fused_s:.4f} s")
    if not equal:
        failures.append("generate_images_fused differs from generate_images")
    if syncs:
        failures.append(f"generate_images_fused synchronised the host {len(syncs)} times: {syncs[:3]}")
    if failures:
        raise AssertionError("main-2048: " + "; ".join(failures))
    return dict(requests=requests, profile=profile_rec,
                fused=dict(equal=equal, host_syncs=len(syncs), enqueue_s=enqueue_s, wall_s=fused_s),
                launches={"flash_attention": blocks * STEPS, "int4_matmul": 24 * 7})



def _to_device(tree, device, dtype):
    """Move a param tree; floating leaves take `dtype` except the f32
    quantization scales."""
    if isinstance(tree, dict):
        return {k: (v.to(device) if k == "kernel_scale" else _to_device(v, device, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device, dtype) for v in tree]
    return tree.to(device, dtype) if tree.is_floating_point() else tree.to(device)


def _small_pipelines(w8a8=None, attn_int8=""):
    """A small Flux config (head dim 128, T5 width 256, every flow dense int8
    per channel, T5 int4 g128, the tiny VAE) → (CPU pipeline in f32, card
    pipeline in bf16) from the same weights, in the given W8A8
    configuration."""
    import torch

    from flux_generator_tpu_torch.models.clip.text import init_clip_text, tiny_clip_config
    from flux_generator_tpu_torch.models.flux.autoencoder import init_autoencoder, tiny_ae_config
    from flux_generator_tpu_torch.models.flux.model import FluxConfig, init_flux
    from flux_generator_tpu_torch.models.t5.t5 import T5Config, init_t5_encoder
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    flow_cfg = FluxConfig(in_channels=64, vec_in_dim=64, context_in_dim=256, hidden_size=256,
                          mlp_ratio=2.0, num_heads=2, depth=1, depth_single_blocks=1)
    t5_cfg = T5Config(vocab_size=64, num_layers=2, num_heads=4, d_kv=64, d_model=256, d_ff=512)
    clip_cfg = tiny_clip_config(model_dims=64)
    ae_cfg = tiny_ae_config(z_channels=16)
    g = torch.Generator().manual_seed(5)
    params = {"flow": init_flux(g, flow_cfg), "ae": init_autoencoder(g, ae_cfg),
              "clip": init_clip_text(g, clip_cfg), "t5": init_t5_encoder(g, t5_cfg)}
    params["flow"] = quantize_tree(params["flow"], lambda p: True)
    params["t5"] = quantize_tree(params["t5"], lambda p: True, bits=4, group_size=128, pack=True)
    cpu = FluxPipeline("flux-schnell", params, flow_cfg, ae_cfg, clip_cfg, t5_cfg, dtype=torch.float32,
                       w8a8=w8a8, attn_int8=attn_int8)
    gpu = FluxPipeline("flux-schnell", _to_device(params, "cuda", torch.bfloat16), flow_cfg, ae_cfg,
                       clip_cfg, t5_cfg, dtype=torch.bfloat16, w8a8=w8a8, attn_int8=attn_int8)
    return cpu, gpu


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _small_flux(tag: str, w8a8=None, attn_int8=""):
    """The small config on the card in bf16 with the kernels, against the
    CPU in f32 with the plain versions, from the same weights, tokens and
    noise, in the given W8A8 configuration. Returns the latent's and the
    image's rel-L2 and the card's launch counts."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.pipelines.flux import latent_ids, pack_latents

    cpu, gpu = _small_pipelines(w8a8, attn_int8)

    rng = np.random.default_rng(6)
    t5_tok = torch.from_numpy(rng.integers(1, 64, (1, 64)))
    clip_tok = torch.from_numpy(rng.integers(1, 64, (1, 16)))
    noise = torch.from_numpy(rng.standard_normal((1, 16, 16, 16)).astype(np.float32))
    outs = {}
    for name, pipe in (("cpu", cpu), ("gpu", gpu)):
        dev = pipe.device
        c0 = _launch_counts()
        txt, txt_ids, vec = pipe.prepare_conditioning(1, t5_tok.to(dev), clip_tok.to(dev))
        x_t = pack_latents(noise.to(dev, pipe.dtype))
        lat = pipe.denoise_latents(x_t, latent_ids(1, 16, 16, device=dev), txt, txt_ids, vec, STEPS, 0.0)
        outs[name] = (lat.float().cpu(), pipe.decode(lat, (16, 16)).float().cpu())
        counts = {key: v - c0[key] for key, v in _launch_counts().items()}

    lat_err = _rel(outs["gpu"][0], outs["cpu"][0])
    img_err = _rel(outs["gpu"][1], outs["cpu"][1])
    log(f"[{tag}] latent rel-L2 {lat_err:.3e}, image rel-L2 {img_err:.3e} (tol {SMALL_REL_TOL}) | "
        f"launches on the card {counts}")
    if not (lat_err <= SMALL_REL_TOL and img_err <= SMALL_REL_TOL):
        raise AssertionError(f"{tag}: the card's run disagrees with the CPU reference")
    return dict(latent_rel_l2=lat_err, image_rel_l2=img_err, launches=counts)


def phase_small():
    out = _small_flux("small")
    if out["launches"]["flash_attention"] != 2 * STEPS or out["launches"]["int4_matmul"] != 2 * 7:
        raise AssertionError("small config did not run the kernels on the card")
    return out


@contextlib.contextmanager
def _numpy_noise(seed: int):
    """Every sample_prior draw of the port is standard-normal noise from
    numpy (`seed`), moved to the generator's device: the CPU's and the
    card's generators give different streams, and a card-against-CPU check
    needs the same noise on both."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.models.flux import sampler

    real = sampler.sample_prior

    def draw(generator, shape, dtype, device=None):
        arr = np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)
        return torch.from_numpy(arr).to(generator.device if device is None else device, dtype)

    sampler.sample_prior = draw
    try:
        yield
    finally:
        sampler.sample_prior = real


def phase_small_tiled():
    """The small config past the untiled sizes, on the card against the
    CPU: a decode of a 136² latent (tiled: 4 tiles of 96² latents) and an
    img2img request on a 1040 x 32 image (a tiled encode: 2 tiles of 768
    rows) at strength 0.5, 4 steps, with the same noise on both sides."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im

    cpu, gpu = _small_pipelines()
    rng = np.random.default_rng(31)
    h = w = 136
    z = torch.from_numpy(rng.standard_normal((1, h * w // 4, 4 * cpu.ae_cfg.z_channels)).astype(np.float32))
    imgs = {name: pipe.decode(z.to(pipe.device, pipe.dtype), (h, w)).float().cpu()
            for name, pipe in (("cpu", cpu), ("gpu", gpu))}
    dec_err = _rel(imgs["gpu"], imgs["cpu"])
    log(f"[small-tiled] decode of a {h}x{w} latent (tiled) {tuple(imgs['gpu'].shape)}: rel-L2 {dec_err:.3e} "
        f"(tol {SMALL_REL_TOL})")

    image = np.tanh(rng.standard_normal((1, 1040, 32, 3))).astype(np.float32)
    t5_tok = rng.integers(1, 64, (1, 64))
    clip_tok = rng.integers(1, 64, (1, 16))
    lats, counts = {}, {}
    for name, pipe in (("cpu", cpu), ("gpu", gpu)):
        pipe.t5_tokenizer = _FixedTokens(t5_tok.tolist())
        pipe.clip_tokenizer = _FixedTokens(clip_tok.tolist())
        fa0, im0 = fa.launches, im.launches
        with _numpy_noise(32):
            steps = list(pipe.generate_latents_from_image(image, "x", strength=0.5, num_steps=STEPS, seed=3))
        lats[name] = steps[-1].float().cpu()
        counts[name] = (fa.launches - fa0, im.launches - im0, len(steps) - 1)
    lat_err = _rel(lats["gpu"], lats["cpu"])
    log(f"[small-tiled] img2img 1040x32 (tiled encode) strength 0.5: {counts['gpu'][2]} steps, latent "
        f"{tuple(lats['gpu'].shape)} rel-L2 {lat_err:.3e} (tol {SMALL_REL_TOL}) | launches on the card A "
        f"{counts['gpu'][0]} B {counts['gpu'][1]}")
    if not (dec_err <= SMALL_REL_TOL and lat_err <= SMALL_REL_TOL):
        raise AssertionError(f"small-tiled: the card disagrees with the CPU: decode {dec_err}, img2img {lat_err}")
    if counts["gpu"] != (2 * 2, 2 * 7, 2):
        raise AssertionError(f"small-tiled img2img: launches A, B and steps {counts['gpu']}, want (4, 14, 2)")
    return dict(decode_rel_l2=dec_err, img2img_latent_rel_l2=lat_err, launches=counts["gpu"][:2])


def phase_small_w8a8():
    """The small config in the W8A8 configuration: "fused" with int8
    attention "qk", and "rows" with "full". A step runs 12 int8-activation
    denses on G (8 in the double block, 2 in the single block, txt_in, the
    final linear) and 13 on H (img_in too: its K of 64 tiles no G block);
    the one-row denses take "ops"."""
    out = {}
    for w8a8, attn_int8 in (("fused", "qk"), ("rows", "full")):
        res = _small_flux(f"small-w8a8 {w8a8}+{attn_int8}", w8a8, attn_int8)
        n = res["launches"]
        want = {"flash_attention": 2 * STEPS, f"flash_attention_int8_{attn_int8}": 2 * STEPS,
                "int4_matmul": 2 * 7, "w8a8_matmul": 12 * STEPS if w8a8 == "fused" else 0,
                "w8a8_quantize_rows": 13 * STEPS if w8a8 == "rows" else 0}
        if any(n[key] != v for key, v in want.items()):
            raise AssertionError(f"small W8A8 config {w8a8}+{attn_int8}: launches {n}, want {want}")
        out[f"{w8a8}+{attn_int8}"] = res
    return out


def phase_kernels_musicgen():
    """Kernels C and D against their plain versions at MusicGen-medium shapes:
    the EnCodec LSTM (d = 1024, T = 497 frames, B = 1) and the 48-layer decode
    step (H = 1536, 24 heads, int8 and bf16 weights, windows of 8 to 2048
    rows, the CFG batch of 2 and a batch of 8 with cond_len masks). D at
    int8 B 2 and B 8 is timed in turns with #11 at M 2 and M 8 on the same
    weights; at B 8 its rows 0-1 must equal a B 2 launch's bit for bit."""
    import torch
    import torch.backends.cudnn.rnn as cudnn_rnn

    from flux_generator_tpu_torch.io.registry import MUSICGEN_MEDIUM_CONFIG as cfg
    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    results, failures = {}, []

    lstm_cases = []
    for label, d, t, b, wd in (("d1024_T497_bf16", 1024, 497, 1, torch.bfloat16),
                               ("d512_T497_f32", 512, 497, 1, torch.float32)):
        xw = (torch.randn((b, t, 4 * d), generator=g, device=dev) * 0.5).to(wd)
        wh = (torch.randn((d, 4 * d), generator=g, device=dev) / d ** 0.5).to(wd)
        out = lk.lstm_recurrence(xw, wh, torch.float32)
        ref = lk.lstm_recurrence_plain(xw, wh, torch.float32)
        err = (out - ref).abs().max().item()
        tol = LSTM_TOL["bf16" if wd == torch.bfloat16 else "f32"]
        ms = time_ms(lambda: lk.lstm_recurrence(xw, wh, torch.float32), iters=10)
        plain_ms = time_ms(lambda: lk.lstm_recurrence_plain(xw, wh, torch.float32), iters=2, warmup=1)
        # yardstick: cuDNN's nn.LSTM, one layer of width d in the same dtype (it
        # also does the input projection the kernel takes as xw), its weights
        # compacted once into cuDNN's one-buffer layout so that no call copies
        # them (flatten_parameters() skips bf16, which torch.backends.cudnn
        # does not list as acceptable, so the layout is made directly); device time
        cudnn = torch.nn.LSTM(d, d, batch_first=True).to(dev, wd)
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(cudnn._flat_weights, 4, d,
                                            cudnn_rnn.get_cudnn_mode("LSTM"), d, 0, 1,
                                            True, False)
        x_in = torch.randn((b, t, d), generator=g, device=dev).to(wd)
        with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cudnn(x_in)
            compacted = not any("compacted at every call" in str(w.message) for w in caught)
            library_ms = device_ms(lambda: cudnn(x_in))
        # xw and Wh read, f32 h written; 2·d·4d operations a step
        bound = bound_ms(2 * t * b * d * 4 * d, xw.numel() * xw.element_size()
                         + wh.numel() * wh.element_size() + b * t * d * 4)
        log(f"[kernels] lstm {label}: max|Δ| {err:.3e} (tol {tol}) | kernel {ms:.4f} ms "
            f"({ms * 1e3 / t:.2f} us/step) | plain {plain_ms:.4f} ms | cuDNN LSTM {library_ms:.4f} ms"
            f" (weights compacted once: {compacted}) | bound {bound[0]:.4f} ms ({bound[1]})")
        if not err <= tol:
            failures.append(f"lstm {label}: {err} > {tol}")
        lstm_cases.append(dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, library_weights_compacted=compacted,
                               bound_ms=bound[0], bound_by=bound[1]))
    results["lstm"] = lstm_cases

    L, H, heads, s_text = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads, 16
    packs = _decode_packs(g, L, H)
    decode_cases = []
    for label, wkey, b, w, offset, masked in (
            ("int8_B2_W8_off5", "int8", 2, 8, 5, False),
            ("int8_B2_W500_off250", "int8", 2, 500, 250, False),
            ("int8_B2_W500_off499", "int8", 2, 500, 499, True),
            ("int8_B8_W2048_off1900", "int8", 8, 2048, 1900, True),
            ("bf16_B2_W500_off499", "bf16", 2, 500, 499, True),
            ("bf16_B8_W2048_off100", "bf16", 8, 2048, 100, True)):
        packed = packs[wkey]
        x = torch.randn((b, H), generator=g, device=dev).to(torch.bfloat16)
        ck = torch.randn((L, b, s_text, H), generator=g, device=dev).to(torch.bfloat16)
        cv = torch.randn((L, b, s_text, H), generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn((L, b, w, H), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((L, b, w, H), generator=g, device=dev).to(torch.bfloat16)
        cl = torch.full((b,), s_text, dtype=torch.int32, device=dev)
        if masked:
            cl[1::2] = 5
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        y, k1, v1 = ds.fused_decode_step(packed, x, ck, cv, offset, k1, v1, cl, n_heads=heads)
        ref, k2, v2 = ds.fused_decode_step_plain(packed, x, ck, cv, offset, k2, v2, cl, n_heads=heads)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        tol = DECODE_REL_TOL * ref.float().abs().max().item()
        row_err = max((a[:, :, offset].float() - c[:, :, offset].float()).abs().max().item()
                      for a, c in ((k1, k2), (v1, v2)))
        row_tol = DECODE_REL_TOL * max(k2[:, :, offset].float().abs().max().item(),
                                       v2[:, :, offset].float().abs().max().item())
        untouched = torch.equal(torch.cat([k1[:, :, :offset], k1[:, :, offset + 1:]], 2),
                                torch.cat([kc[:, :, :offset], kc[:, :, offset + 1:]], 2))
        step = lambda: ds.fused_decode_step(packed, x, ck, cv, offset, k1, v1, cl, n_heads=heads)  # noqa: E731
        chain_ms = phases = None
        if label in ("int8_B2_W500_off250", "int8_B8_W2048_off1900"):
            # in turns with #11, the weight stream of D's first design alone, at the same rows and weights
            chain = lambda: dc.decode_chain(packed["w"], packed["s"], x)  # noqa: E731
            t = [time_ms(f) for f in (step, chain, chain, step)]
            ms, chain_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            # D's phase split: block 0's device clock after each grid sync, summed over the layers
            phases = ds.phase_times(packed, x, ck, cv, offset, k1, v1, cl, n_heads=heads)
            log(f"[kernels] decode {label} phase split, us a step (sync to sync): "
                + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()) + f" | sum {sum(phases.values()):.1f}")
        else:
            ms = time_ms(step)
        plain_ms = time_ms(lambda: ds.fused_decode_step_plain(packed, x, ck, cv, offset, k2, v2, cl,
                                                              n_heads=heads), iters=3, warmup=1)
        batch_free = None
        if b == 8:
            # rows 0-1 of this launch against a launch of those two rows alone, bit for bit
            y8, k8, v8 = ds.fused_decode_step(packed, x, ck, cv, offset, kc.clone(), vc.clone(), cl, n_heads=heads)
            ck2, cv2, kc2, vc2 = (t[:, :2].contiguous() for t in (ck, cv, kc, vc))
            y2, k2b, v2b = ds.fused_decode_step(packed, x[:2].contiguous(), ck2, cv2, offset, kc2, vc2,
                                                cl[:2].contiguous(), n_heads=heads)
            batch_free = (torch.equal(y8[:2].view(torch.int16), y2.view(torch.int16))
                          and torch.equal(k8[:, :2, offset].view(torch.int16), k2b[:, :, offset].view(torch.int16))
                          and torch.equal(v8[:, :2, offset].view(torch.int16), v2b[:, :, offset].view(torch.int16)))
            del y8, k8, v8, ck2, cv2, kc2, vc2, y2, k2b, v2b
        # bytes the step must read: weights, scales, LN, the live text rows of
        # cross K/V (cond_len of each row), live cache rows
        nbytes = (packed["w"].numel() * packed["w"].element_size() + packed["s"].numel() * 2
                  + packed["ln"].numel() * 2 + 2 * L * int(cl.sum().item()) * H * 2 + 2 * L * b * offset * H * 2)
        bound = bound_ms(2 * b * packed["w"].numel(), nbytes)
        log(f"[kernels] decode {label}: max|Δ| {err:.3e} (tol {tol:.3e}), new rows {row_err:.3e} "
            f"(tol {row_tol:.3e}), other rows untouched {untouched} | kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e9:.3f} GB; bound {bound[0]:.4f} ms, {bound[1]}) | plain "
            f"{plain_ms:.4f} ms" + ("" if chain_ms is None else f" | #11 at M {b} in turns {chain_ms:.4f} ms "
                                    f"(D {ms - chain_ms:+.4f})")
            + ("" if batch_free is None else f" | rows 0-1 equal a B 2 launch bit for bit: {batch_free}"))
        if not (err <= tol and row_err <= row_tol and untouched and batch_free is not False):
            failures.append(f"decode {label}: y {err} (tol {tol}), rows {row_err} (tol {row_tol}), "
                            f"untouched {untouched}, rows independent of B {batch_free}")
        decode_cases.append(dict(case=label, max_abs_err=err, rel_err=err / tol * DECODE_REL_TOL,
                                 ms=ms, plain_ms=plain_ms, bytes=nbytes, library_ms=None,
                                 bound_ms=bound[0], bound_by=bound[1], chain_ms_in_turns=chain_ms,
                                 rows_independent_of_batch=batch_free, phase_us=phases))
        del kc, vc, k1, v1, k2, v2
    results["decode_step"] = decode_cases
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("kernels disagree with their plain versions: " + "; ".join(failures))
    return results


def _e4m3_steps(a, b) -> int:
    """The largest distance in e4m3 codes between two e4m3 tensors (0: the
    same bytes; ±0 are one code)."""
    import torch

    def code(t):
        u = t.view(torch.uint8).to(torch.int32)
        return torch.where(u >= 128, -(u & 0x7F), u)

    return int((code(a) - code(b)).abs().max().item())


def _decode_packs(g, n_layers: int, h: int):
    """Kernel D's packed weights at full width, int8 per channel and bf16,
    with unit-scale outputs, and LN params near 1 / 0."""
    import torch

    dev = torch.device("cuda")
    n = n_layers * 14
    ln = torch.stack([1 + 0.1 * torch.randn((n_layers, h), generator=g, device=dev),
                      0.1 * torch.randn((n_layers, h), generator=g, device=dev)], dim=1).repeat(1, 4, 1)
    ln = ln.to(torch.bfloat16).contiguous()
    return {
        "int8": {"w": torch.randint(-127, 128, (n, h, h), generator=g, device=dev, dtype=torch.int8),
                 "s": ((0.5 + torch.rand((n, 1, h), generator=g, device=dev)) / (127 * h ** 0.5)
                       ).to(torch.bfloat16), "ln": ln},
        "bf16": {"w": (torch.randn((n, h, h), generator=g, device=dev) / h ** 0.5).to(torch.bfloat16),
                 "s": torch.ones((n, 1, h), dtype=torch.bfloat16, device=dev), "ln": ln},
    }


def phase_kernels_musicgen_f8():
    """Kernel D's e4m3 cache tier against its plain version at MusicGen-medium
    shapes (48 layers, H 1536, 24 heads), on e4m3 copies of bf16 caches: one
    long request's last step (B 2, W 2500, offset 2499), four coalesced
    requests (B 8, W 2048, offset 1900) and bf16 weights (B 2, W 500, offset
    250). y is held to the plain version, and layer 0's new rows (whose
    inputs do not depend on the cache) to within one e4m3 step of its rows.
    The e4m3 tier widens the cache exactly and sums in the bf16 tier's order,
    so the bf16 tier on the widened caches must give the same y bit for bit,
    and its new rows at every layer, encoded by store_kv_rows, the e4m3
    tier's bytes. The bf16 tier on the original bf16 caches is timed in
    turns with the e4m3 tier, and y's rel-L2 between the two is logged."""
    import torch

    from flux_generator_tpu_torch.io.registry import MUSICGEN_MEDIUM_CONFIG as cfg
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678)
    L, H, heads, s_text = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads, 16
    packs = _decode_packs(g, L, H)
    e4m3 = torch.float8_e4m3fn
    cases, failures = [], []
    for label, wkey, b, w, offset in (("int8_B2_W2500_off2499", "int8", 2, 2500, 2499),
                                      ("int8_B8_W2048_off1900", "int8", 8, 2048, 1900),
                                      ("bf16_B2_W500_off250", "bf16", 2, 500, 250)):
        packed = packs[wkey]
        x = torch.randn((b, H), generator=g, device=dev).to(torch.bfloat16)
        ck = torch.randn((L, b, s_text, H), generator=g, device=dev).to(torch.bfloat16)
        cv = torch.randn((L, b, s_text, H), generator=g, device=dev).to(torch.bfloat16)
        cl = torch.full((b,), s_text, dtype=torch.int32, device=dev)
        cl[1::2] = 5
        kc16 = torch.randn((L, b, w, H), generator=g, device=dev).to(torch.bfloat16)
        vc16 = torch.randn((L, b, w, H), generator=g, device=dev).to(torch.bfloat16)
        kc8, vc8 = kc16.to(e4m3), vc16.to(e4m3)  # |v| < 448: no overflow
        k1, v1, k2, v2 = kc8.clone(), vc8.clone(), kc8.clone(), vc8.clone()
        y, k1, v1 = ds.fused_decode_step(packed, x, ck, cv, offset, k1, v1, cl, n_heads=heads)
        ref, k2, v2 = ds.fused_decode_step_plain(packed, x, ck, cv, offset, k2, v2, cl, n_heads=heads)
        yw, kw, vw = ds.fused_decode_step(packed, x, ck, cv, offset, kc8.to(torch.bfloat16),
                                          vc8.to(torch.bfloat16), cl, n_heads=heads)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        tol = DECODE_F8_REL_TOL * ref.float().abs().max().item()
        row_steps = max(_e4m3_steps(a[0, :, offset], c[0, :, offset]) for a, c in ((k1, k2), (v1, v2)))
        y_bitwise = torch.equal(y.view(torch.int16), yw.view(torch.int16))
        rows_bitwise = all(torch.equal(a[:, :, offset].view(torch.uint8),
                                       ds.store_kv_rows(r[:, :, offset], e4m3).view(torch.uint8))
                           for a, r in ((k1, kw), (v1, vw)))
        untouched = all(torch.equal(torch.cat([a[:, :, :offset], a[:, :, offset + 1:]], 2).view(torch.uint8),
                                    torch.cat([c[:, :, :offset], c[:, :, offset + 1:]], 2).view(torch.uint8))
                        for a, c in ((k1, kc8), (v1, vc8)))
        del yw, kw, vw
        y16, k16, v16 = ds.fused_decode_step(packed, x, ck, cv, offset, kc16.clone(), vc16.clone(), cl,
                                             n_heads=heads)
        rel_bf16 = ((y.float() - y16.float()).norm() / y16.float().norm()).item()
        step8 = lambda: ds.fused_decode_step(packed, x, ck, cv, offset, k1, v1, cl, n_heads=heads)  # noqa: E731
        step16 = lambda: ds.fused_decode_step(packed, x, ck, cv, offset, k16, v16, cl, n_heads=heads)  # noqa: E731
        t8a, t16a, t16b, t8b = time_ms(step8), time_ms(step16), time_ms(step16), time_ms(step8)
        ms, ms_bf16 = (t8a + t8b) / 2, (t16a + t16b) / 2
        plain_ms = time_ms(lambda: ds.fused_decode_step_plain(packed, x, ck, cv, offset, k2, v2, cl,
                                                              n_heads=heads), iters=3, warmup=1)
        # bytes the step must read (weights, scales, LN, the live text rows of
        # cross K/V, the live cache rows) and write (y, the new rows), cache
        # elements 1 or 2 bytes
        fixed = (packed["w"].numel() * packed["w"].element_size() + packed["s"].numel() * 2
                 + packed["ln"].numel() * 2 + 2 * L * int(cl.sum().item()) * H * 2 + 2 * b * H * 2)
        bound = bound_ms(2 * b * packed["w"].numel(), fixed + 2 * L * b * (offset + 1) * H)
        bound16 = bound_ms(2 * b * packed["w"].numel(), fixed + 2 * L * b * (offset + 1) * H * 2)
        log(f"[kernels-musicgen-f8] decode {label}: max|Δy| {err:.3e} (tol {tol:.3e}), layer 0's new rows "
            f"{row_steps} e4m3 steps apart (tol 1) | bf16 tier on the widened caches: y bitwise {y_bitwise}, "
            f"new rows of all {L} layers encoded bitwise {rows_bitwise} | other rows untouched {untouched} | "
            f"e4m3 {ms:.4f} ms (bound {bound[0]:.4f}, {bound[1]}) | bf16 cache {ms_bf16:.4f} ms (bound "
            f"{bound16[0]:.4f}) | plain {plain_ms:.4f} ms | y rel-L2 e4m3 vs bf16 caches {rel_bf16:.3e} "
            f"(no bound)")
        if not (err <= tol and row_steps <= 1 and y_bitwise and rows_bitwise and untouched
                and torch.isfinite(y).all()):
            failures.append(f"decode_f8 {label}: y {err} (tol {tol}), layer 0 rows {row_steps} steps, against "
                            f"the bf16 tier y {y_bitwise} rows {rows_bitwise}, untouched {untouched}")
        cases.append(dict(case=label, max_abs_err=err, rel_err=err / tol * DECODE_F8_REL_TOL,
                          layer0_row_e4m3_steps=row_steps, y_equals_bf16_tier_on_widened=y_bitwise,
                          rows_equal_bf16_tier_on_widened=rows_bitwise, ms=ms, ms_bf16_cache=ms_bf16,
                          plain_ms=plain_ms, library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                          bound_bf16_cache_ms=bound16[0], y_rel_l2_vs_bf16_cache=rel_bf16))
        del kc16, vc16, kc8, vc8, k1, v1, k2, v2, k16, v16
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("D's e4m3 tier disagrees with its plain version: " + "; ".join(failures))
    return {"decode_step_f8": cases}


def phase_kernels_chain():
    """The decode-chain probe (#11) against its plain version at 48 layers,
    M 8 and M 2 (D's two live rows), on the probe's own inputs; its times in
    turns with kernel D (int8 weights, bf16 cache, B 2, W 500, offset 250) on
    the same weights, the floor beside the step; then one run of the probe's
    entry point, whose launches are the line's."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.scripts import prof_decode_chain as probe

    dev = torch.device("cuda")
    L, H, heads = 48, probe.H, 24
    w, s, x = probe.make_inputs(L, dev)
    y = dc.decode_chain(w, s, x)
    ref = dc.decode_chain_plain(w, s, x)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = CHAIN_REL_TOL * ref.float().abs().max().item()
    g = torch.Generator(device=dev).manual_seed(91)
    packed = {"w": w, "s": s, "ln": (1 + 0.1 * torch.randn((L, 8, H), generator=g, device=dev)
                                     ).to(torch.bfloat16)}
    xd = torch.randn((2, H), generator=g, device=dev).to(torch.bfloat16)
    ck = torch.randn((L, 2, 16, H), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((L, 2, 500, H), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((L, 2, 500, H), generator=g, device=dev).to(torch.bfloat16)
    x2 = x[:2].contiguous()  # the two live CFG rows, as D runs them
    err2 = (dc.decode_chain(w, s, x2).float() - dc.decode_chain_plain(w, s, x2).float()).abs().max().item()
    chain = lambda: dc.decode_chain(w, s, x)  # noqa: E731
    chain2 = lambda: dc.decode_chain(w, s, x2)  # noqa: E731
    step = lambda: ds.fused_decode_step(packed, xd, ck, ck, 250, kc, vc, n_heads=heads)  # noqa: E731
    t = [time_ms(f) for f in (chain, chain2, step, step, chain2, chain)]
    ms, ms2, d_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
    plain_ms = time_ms(lambda: dc.decode_chain_plain(w, s, x), iters=2, warmup=1)
    nbytes = w.numel() + 2 * s.numel() + 2 * 2 * x.numel()
    bound = bound_ms(2 * x.shape[0] * w.numel(), nbytes)
    log(f"[kernels-chain] decode chain L48 M8: max|Δ| {err:.3e} (tol {tol:.3e}), M2 {err2:.3e} | kernel "
        f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), at M 2 {ms2:.4f} ms | plain {plain_ms:.4f} ms | bound "
        f"{bound[0]:.4f} ms ({bound[1]}) | D (int8, bf16 cache, B 2, W 500, off 250) {d_ms:.4f} ms in turns: "
        f"D {d_ms - ms2:+.4f} ms against #11 at M 2 (#11 is the weight stream of D's first design alone, "
        f"kept as a fixed yardstick)")
    err = max(err, err2)
    del packed, xd, ck, kc, vc, w, s, x, x2, y, ref
    if not err <= tol:
        raise AssertionError(f"the decode chain disagrees with its plain version: {err} > {tol}")
    dc.launches = 0
    run = probe.run(layers=L, steps=50)
    launches = dc.launches
    log(f"[kernels-chain] probe entry point (48 layers, 50 steps): rel err {run['rel_err']:.3e}, kernel "
        f"{run['ms']:.4f} ms/step, plain {run['plain_ms']:.4f} ms/step, bound {run['bound_ms']:.4f} ms, "
        f"{launches} launches")
    if not (run["rel_err"] <= CHAIN_REL_TOL and run["finite"] and launches > 0):
        raise AssertionError(f"the probe's run failed: {run}, {launches} launches")
    return {"decode_chain": [dict(case="L48_M8", max_abs_err=err, ms=ms, m2_ms=ms2, plain_ms=plain_ms,
                                  library_ms=None, bound_ms=bound[0], bound_by=bound[1],
                                  decode_step_ms_in_turns=d_ms, probe=run, launches=launches)]}


def phase_kernels_chain_bisect(chain):
    """The chain-bisect probe (#12) against its plain version at 48 layers, M 8
    and M 2, for each of its eight cumulative rungs, on #11's weights and
    seeded random LN params, cross K/V and caches (W 512, chunk 512); each
    rung timed in turns with #11 (#11, rung, rung, #11 twice over) and shown
    beside D's time from `chain` (kernels-chain's record). A control must miss
    the tolerance: the no-extras rung's output against the ln rung's plain
    output. Then the attribution of D's first design (decode_common.cuh),
    kept for #12: each rung's cost over #11 less the rung before's (each in
    its own turns), summed beside today's D − #11 at 2 rows (D now has
    projections of its own, so the sum no longer accounts for that gap); and
    one run of the probe's entry point (the script's ladder, then every
    extra), whose launches are the line's."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import chain_bisect as cb
    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.scripts import prof_chain_bisect as probe
    from flux_generator_tpu_torch.scripts import prof_decode_chain as chain_probe

    dev = torch.device("cuda")
    L, H, window = 48, probe.H, 512
    d_ms = chain["decode_step_ms_in_turns"]
    w, s, x8 = chain_probe.make_inputs(L, dev)
    every = probe.make_extra_operands(cb.RUNGS[-1], L, window, dev)
    cases, failures = [], []
    for m in (8, 2):
        x = x8[:m].contiguous()
        for spec in cb.RUNGS:
            ex = cb.parse_extras(spec)
            ops = {k: v for k, v in every.items() if cb.OPERAND_EXTRA[k] in ex}
            got = cb.chain_bisect(w, s, x, spec, **ops)
            ref = cb.chain_bisect_plain(w, s, x, spec, **ops)
            torch.cuda.synchronize()
            errs = probe.rel_errors(got, ref)
            y = got[0] if isinstance(got, tuple) else got
            yr = ref[0] if isinstance(ref, tuple) else ref
            abs_err = (y.float() - yr.float()).abs().max().item()
            finite = all(bool(torch.isfinite(t.float()).all()) for t in (got if isinstance(got, tuple) else (got,)))
            rung = lambda: cb.chain_bisect(w, s, x, spec, **ops)  # noqa: E731
            chain11 = lambda: dc.decode_chain(w, s, x)  # noqa: E731
            t = [time_ms(f, iters=30) for f in (chain11, rung, rung, chain11) * 2]
            ms, chain_ms = statistics.mean(t[1::4] + t[2::4]), statistics.mean(t[0::4] + t[3::4])
            plain_ms = time_ms(lambda: cb.chain_bisect_plain(w, s, x, spec, **ops), iters=2, warmup=1)
            nbytes = probe.step_bytes(spec, L, m, window)
            bound = bound_ms(2 * m * w.numel(), nbytes)
            plan = cb.plan(m, H, spec)
            log(f"[kernels-chain-bisect] M {m} rung {spec or '-'}: max|Δ|/max {errs} (tol {CHAIN_REL_TOL}) | "
                f"kernel {ms:.4f} ms, #11 in turns {chain_ms:.4f} ms ({ms - chain_ms:+.4f}), D {d_ms:.4f} ms | plain "
                f"{plain_ms:.4f} ms"
                f" | bound {bound[0]:.4f} ms ({bound[1]}, {nbytes / 1e9:.4f} GB) | grid {plan['grid']}, "
                f"{plan['blocks_per_sm']} blocks/SM, {plan['smem_bytes']} B shared a block")
            if not (max(errs.values()) <= CHAIN_REL_TOL and finite):
                failures.append(f"M {m} rung {spec!r}: {errs}, finite {finite}")
            cases.append(dict(case=f"M{m}_{spec or 'none'}", rows=m, extras=spec, max_abs_err=abs_err, rel_errs=errs,
                              ms=ms, chain_ms_in_turns=chain_ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound[0],
                              bound_by=bound[1], library_ms=None, **plan))
    ops = {k: v for k, v in every.items() if cb.OPERAND_EXTRA[k] in ("smem", "ln")}
    control = probe.rel_errors(cb.chain_bisect(w, s, x8, ""), cb.chain_bisect_plain(w, s, x8, "smem,ln", **ops))["y"]
    log(f"[kernels-chain-bisect] control: the no-extras kernel against the ln rung's plain version "
        f"{control:.3e} of max (must miss {CHAIN_REL_TOL})")
    if not control > CHAIN_REL_TOL:
        failures.append(f"the control passed the check: {control}")
    d_minus_chain = d_ms - chain["m2_ms"]
    attribution = {}
    for m in (8, 2):
        rows = [c for c in cases if c["rows"] == m]
        excess = [c["ms"] - c["chain_ms_in_turns"] for c in rows]
        deltas = [excess[0]] + [b - a for a, b in zip(excess, excess[1:])]
        attribution[m] = dict(zip([c["extras"] or "none" for c in rows], deltas))
        log(f"[kernels-chain-bisect] M {m} attribution, ms over the rung before (the first over #11): " + ", ".join(
            f"{k} {v:+.4f}" for k, v in attribution[m].items()) + f" | sum {sum(deltas):+.4f} ms" +
            (f" (the attribution of D's first design, kept for #12) beside today's D − #11 at 2 rows "
             f"{d_minus_chain:+.4f} ms (kernels-chain: D {d_ms:.4f}, #11 {chain['m2_ms']:.4f})" if m == 2 else ""))
    del w, s, x8, every, ops
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("the chain bisect disagrees with its plain version: " + "; ".join(failures))
    cb.launches = 0
    runs = probe.run(ladder=True, steps=50)["rungs"] + probe.run(cb.RUNGS[-1], steps=50)["rungs"]
    launches = cb.launches
    for r in runs:
        log(f"[kernels-chain-bisect] entry point rung {r['extras'] or '-'}: rel err {r['rel_err']:.3e}, "
            f"{r['ms']:.4f} ms/step, bound {r['bound_ms']:.4f} ms, {r['blocks_per_sm']} blocks/SM")
    log(f"[kernels-chain-bisect] entry point (the script's ladder, then every extra; 48 layers, 50 steps): "
        f"{launches} launches")
    if not (all(r["rel_err"] <= CHAIN_REL_TOL and r["finite"] for r in runs) and launches > 0):
        raise AssertionError(f"the probe's run failed: {runs}, {launches} launches")
    return {"chain_bisect": dict(cases=cases, control_rel_err=control, attribution=attribution,
                                 d_minus_chain_ms=d_minus_chain, probe=runs, launches=launches)}


def _serve_requests(steps):
    return [{"text": t, "max_steps": n, "seed": i + 1} for i, (t, n) in enumerate(zip(SERVE_TEXTS, steps))]


def phase_main_musicgen_serve(pipe):
    """The served MusicGen path on main-musicgen's pipeline: four users'
    requests (SERVE_TEXTS, 250/500/1000/1500 steps, seeds 1-4, top_k 250,
    guidance 3) in one generate_requests loop, on bf16 and then e4m3 caches;
    then at top_k 1 (64/96/128/160 steps) each request's codes coalesced
    against its solo run, on both cache types."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    cfg, codec = pipe.cfg, pipe.audio_decoder.cfg
    k, n_lstm = cfg.num_codebooks, codec.num_lstm_layers
    runs = []
    for kv in ("bf16", "f8"):
        pipe.kv_dtype = kv
        pipe.generate_requests(_serve_requests((16,) * 4), top_k=MG_TOP_K)  # warm-up
        torch.cuda.synchronize()
        ds.launches = ds.e4m3_launches = lk.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trace = {}
        t0 = time.perf_counter()
        waves = pipe.generate_requests(_serve_requests(SERVE_STEPS), top_k=MG_TOP_K, guidance_coef=3.0,
                                       trace=trace, step_times=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dec_n, f8_n, lstm_n = ds.launches, ds.e4m3_launches, lk.launches
        want = [((st - k + 1) * codec.hop_length, codec.audio_channels) for st in SERVE_STEPS]
        shapes = [tuple(wv.shape) for wv in waves]
        finite = all(bool(torch.isfinite(wv).all()) for wv in waves)
        audio_s = sum(sh[0] for sh in want) / pipe.sampling_rate
        rec = dict(kv_dtype=kv, wall_s=wall, conditioning_s=trace["conditioning_s"], ar_s=trace["ar_s"],
                   decode_s=trace["decode_s"], ms_per_step=trace["ar_s"] * 1e3 / max(SERVE_STEPS),
                   device_ms_per_step=statistics.mean(trace["step_ms"]), audio_s=audio_s,
                   audio_s_per_s=audio_s / wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   decode_step_launches=dec_n, decode_step_e4m3_launches=f8_n, lstm_launches=lstm_n,
                   shapes=[list(sh) for sh in shapes], finite=finite)
        log(f"[main-musicgen-serve] {kv} caches, 4 requests {SERVE_STEPS} steps: {wall:.4f} s (conditioning "
            f"{rec['conditioning_s']:.4f} + AR {rec['ar_s']:.4f} + decode {rec['decode_s']:.4f}) | "
            f"{rec['ms_per_step']:.3f} ms/step (device {rec['device_ms_per_step']:.3f}) | "
            f"{rec['audio_s_per_s']:.2f} audio-s/s aggregate ({audio_s:.2f} s of audio) | peak "
            f"{rec['peak_gib']:.2f} GiB | launches decode {dec_n} (e4m3 {f8_n}) lstm {lstm_n} | finite {finite}")
        if shapes != want or not finite:
            raise AssertionError(f"waveforms {shapes} (want {want}), finite {finite}")
        if dec_n != max(SERVE_STEPS) or f8_n != (dec_n if kv == "f8" else 0) or lstm_n != 4 * n_lstm:
            raise AssertionError(f"launch counts decode {dec_n} (e4m3 {f8_n}), lstm {lstm_n}; want "
                                 f"{max(SERVE_STEPS)} a loop and {n_lstm} a request")
        runs.append(rec)
    equal = {}
    for kv in ("bf16", "f8"):
        pipe.kv_dtype = kv
        requests = _serve_requests(SERVE_EQUAL_STEPS)
        both = {}
        pipe.generate_requests(requests, top_k=1, trace=both)
        for i, r in enumerate(requests):
            solo = {}
            pipe.generate_requests([r], top_k=1, trace=solo)
            equal[f"{kv}_{i}"] = torch.equal(both["codes"][i], solo["codes"][0])
    pipe.kv_dtype = "bf16"
    log(f"[main-musicgen-serve] top_k 1, {SERVE_EQUAL_STEPS} steps: coalesced codes equal solo codes "
        f"{equal}")
    if not all(equal.values()):
        raise AssertionError(f"coalesced codes differ from solo codes: {equal}")
    return dict(runs=runs, coalesced_equals_solo=equal,
                launches={"decode_step_f8": sum(r["decode_step_e4m3_launches"] for r in runs)})


def phase_main_musicgen_long(pipe):
    """One 2500-step request (about 50 s of audio) on bf16 and e4m3 caches
    in turns (bf16, e4m3, e4m3, bf16), with the device ms a step over its
    first and last 250 steps."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import decode_step as ds

    codec = pipe.audio_decoder.cfg
    want = ((LONG_STEPS - pipe.cfg.num_codebooks + 1) * codec.hop_length, codec.audio_channels)
    audio_s = want[0] / pipe.sampling_rate
    runs, f8_launches = [], 0
    for kv in ("bf16", "f8", "f8", "bf16"):
        pipe.kv_dtype = kv
        torch.cuda.reset_peak_memory_stats()
        ds.launches = ds.e4m3_launches = 0
        trace = {}
        t0 = time.perf_counter()
        audio = pipe.generate(SERVE_TEXTS[-1], max_steps=LONG_STEPS, top_k=MG_TOP_K, seed=7, trace=trace,
                              step_times=True)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        dec_n, f8_n = ds.launches, ds.e4m3_launches
        f8_launches += f8_n
        steps = trace["step_ms"]
        finite = bool(torch.isfinite(audio).all())
        rec = dict(kv_dtype=kv, latency_s=latency, conditioning_s=trace["conditioning_s"], ar_s=trace["ar_s"],
                   decode_s=trace["decode_s"], ms_per_step=trace["ar_s"] * 1e3 / LONG_STEPS,
                   first_250_ms_per_step=statistics.mean(steps[:250]),
                   last_250_ms_per_step=statistics.mean(steps[-250:]), audio_s=audio_s,
                   audio_s_per_s=audio_s / latency, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   decode_step_launches=dec_n, shape=list(audio.shape), finite=finite)
        log(f"[main-musicgen-long] {kv} caches, {LONG_STEPS} steps: {latency:.4f} s (AR {rec['ar_s']:.4f}, "
            f"decode {rec['decode_s']:.4f}) | device ms/step first 250 {rec['first_250_ms_per_step']:.4f}, "
            f"last 250 {rec['last_250_ms_per_step']:.4f} | {rec['audio_s_per_s']:.2f} audio-s/s | peak "
            f"{rec['peak_gib']:.2f} GiB | launches decode {dec_n} | finite {finite}")
        if tuple(audio.shape) != want or not finite or dec_n != LONG_STEPS \
                or f8_n != (LONG_STEPS if kv == "f8" else 0):
            raise AssertionError(f"long request: waveform {tuple(audio.shape)} (want {want}), finite "
                                 f"{finite}, launches {dec_n} (e4m3 {f8_n})")
        runs.append(rec)
    pipe.kv_dtype = "bf16"
    return dict(runs=runs, launches={"decode_step_f8": f8_launches})


def phase_main_musicgen():
    """MusicGen-medium at full width: T5-base and decoder int8 per channel,
    EnCodec f32, as the JAX loader quantizes them; one warm-up and three
    500-step requests with different seeds. Returns the record and the
    pipeline (main-musicgen-serve and main-musicgen-long run on it)."""
    import torch

    from flux_generator_tpu_torch.io.tokenizers import load_t5_tokenizer
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import lstm as lk
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = MusicGenPipeline.random_init(tiny=False, dtype=torch.bfloat16, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.t5_params = quantize_tree(pipe.t5_params)
    pipe.params = quantize_tree(pipe.params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quant_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    resident = torch.cuda.memory_allocated() / 2**30
    pipe.tokenizer = load_t5_tokenizer(ROOT / "tests/assets/spiece/t5_like.model")
    log(f"[main-musicgen] random init {init_s:.2f} s, quantize {quant_s:.2f} s | setup peak "
        f"{setup_peak:.2f} GiB, resident {resident:.2f} GiB | T5 tokens: SentencePiece test asset, "
        f"unpadded")
    cfg, hop = pipe.cfg, pipe.audio_decoder.cfg.hop_length
    want_shape = ((MG_STEPS - cfg.num_codebooks + 1) * hop, pipe.audio_decoder.cfg.audio_channels)
    audio_s = want_shape[0] / pipe.sampling_rate

    t0 = time.perf_counter()
    pipe.generate("warm-up", max_steps=MG_STEPS, top_k=MG_TOP_K, seed=0)
    torch.cuda.synchronize()
    log(f"[main-musicgen] warm-up request {time.perf_counter() - t0:.3f} s (not counted)")

    lk.launches = 0
    ds.launches = 0
    requests, codes = [], []
    for seed, prompt in MG_PROMPTS:
        torch.cuda.reset_peak_memory_stats()
        c0, d0 = lk.launches, ds.launches
        trace = {}
        t0 = time.perf_counter()
        audio = pipe.generate(prompt, max_steps=MG_STEPS, top_k=MG_TOP_K, seed=seed, trace=trace)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        lstm_n, dec_n = lk.launches - c0, ds.launches - d0
        finite = bool(torch.isfinite(audio).all())
        rec = dict(seed=seed, prompt_tokens=len(pipe.tokenizer.encode(prompt, pad=False)[0]),
                   latency_s=latency, conditioning_s=trace["conditioning_s"], ar_s=trace["ar_s"],
                   decode_s=trace["decode_s"], ms_per_step=trace["ar_s"] * 1e3 / MG_STEPS,
                   audio_s=audio_s, audio_s_per_s=audio_s / latency,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, decode_step_launches=dec_n,
                   lstm_launches=lstm_n, shape=list(audio.shape), finite=finite)
        log(f"[main-musicgen] request seed={seed} ({rec['prompt_tokens']} tokens): {latency:.4f} s "
            f"(conditioning {rec['conditioning_s']:.4f} + AR {rec['ar_s']:.4f} + decode "
            f"{rec['decode_s']:.4f}) | {rec['ms_per_step']:.3f} ms/step | {rec['audio_s_per_s']:.2f} "
            f"audio-s/s | peak {rec['peak_gib']:.2f} GiB | launches decode {dec_n} lstm {lstm_n} | "
            f"{tuple(audio.shape)} finite {finite}")
        if tuple(audio.shape) != want_shape or not finite:
            raise AssertionError(f"waveform {tuple(audio.shape)} (want {want_shape}), finite {finite}")
        if dec_n != MG_STEPS or lstm_n != pipe.audio_decoder.cfg.num_lstm_layers:
            raise AssertionError(f"launch counts decode {dec_n} (want {MG_STEPS}), lstm {lstm_n} "
                                 f"(want {pipe.audio_decoder.cfg.num_lstm_layers})")
        requests.append(rec)
        codes.append(trace["codes"])
    if any(torch.equal(codes[0], other) for other in codes[1:]):
        raise AssertionError("requests with different seeds gave identical codes")
    return dict(init_s=init_s, quantize_s=quant_s, setup_peak_gib=setup_peak, resident_gib=resident,
                requests=requests, launches={"lstm": lk.launches, "decode_step": ds.launches}), pipe


def phase_small_musicgen():
    """A small MusicGen config (hidden 256, 4 heads of 64, ffn = 4h, int8
    decoder) and a small EnCodec (LSTM d = 64, f32) on the card in bf16 with
    the kernels, against the CPU in f32 with the plain versions:
    teacher-forced logits over 16 steps and the waveform of fixed codes."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.models.musicgen import model as mg
    from flux_generator_tpu_torch.models.musicgen.encodec import EncodecModel, tiny_encodec_config
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import lstm as lk
    from flux_generator_tpu_torch.ops.quant import quantize_tree

    cfg = mg.tiny_musicgen_config(hidden_size=256, num_attention_heads=4, ffn_dim=1024,
                                  num_hidden_layers=2, codebook_size=64, bos_token_id=64)
    enc_cfg = tiny_encodec_config(num_filters=16, codebook_size=64)
    g = torch.Generator().manual_seed(8)
    params = mg.init_musicgen(g, cfg)
    params["layers"] = quantize_tree(params["layers"], lambda p: True)
    codec = EncodecModel.random_init(enc_cfg, g)
    gpu_params = _to_device(params, "cuda", torch.bfloat16)
    gpu_codec = EncodecModel(enc_cfg, _to_device(codec.params, "cuda", torch.float32))

    rng = np.random.default_rng(9)
    steps = 16
    tokens = torch.from_numpy(rng.integers(0, cfg.codebook_size, (steps, 2, 1, cfg.num_codebooks)))
    cond = torch.from_numpy(rng.standard_normal((1, 6, cfg.hidden_size)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, enc_cfg.codebook_size, (1, enc_cfg.num_quantizers, 20)))
    c0, d0 = lk.launches, ds.launches
    outs = {}
    for name, p, codec_, dev, dt in (("cpu", params, codec, "cpu", torch.float32),
                                     ("gpu", gpu_params, gpu_codec, "cuda", torch.bfloat16)):
        c = cond.to(dev, dt)
        cross = mg.precompute_cross_kv(p, cfg, torch.cat([c, torch.zeros_like(c)]))
        ckv = tuple(a.reshape(cfg.num_hidden_layers, 2, a.shape[2], cfg.hidden_size) for a in cross)
        packed = ds.pack_decode_weights(p["layers"], cfg.hidden_size, cfg.ffn_dim)
        kc = torch.zeros((cfg.num_hidden_layers, 2, steps, cfg.hidden_size), dtype=dt, device=dev)
        vc = torch.zeros_like(kc)
        logits = []
        for i in range(steps):
            lg, kc, vc = mg.decode_step_fused(packed, p, cfg, tokens[i].to(dev), ckv, kc, vc, i)
            logits.append(lg.float().cpu())
        wave = codec_.decode(codes.to(dev)[None], [None]).float().cpu()
        outs[name] = (torch.stack(logits), wave)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    logit_err = rel(outs["gpu"][0], outs["cpu"][0])
    wave_err = rel(outs["gpu"][1], outs["cpu"][1])
    log(f"[small-musicgen] teacher-forced logits rel-L2 {logit_err:.3e}, waveform rel-L2 "
        f"{wave_err:.3e} (tol {SMALL_REL_TOL})")
    if ds.launches - d0 != steps or lk.launches - c0 != enc_cfg.num_lstm_layers:
        raise AssertionError("small MusicGen config did not run the kernels on the card")
    if not (logit_err <= SMALL_REL_TOL and wave_err <= SMALL_REL_TOL):
        raise AssertionError("the card's MusicGen run disagrees with the CPU reference")
    return dict(logits_rel_l2=logit_err, waveform_rel_l2=wave_err)


def phase_kernels_train():
    """Kernels E (dQ) and F (dK, dV) through the autograd function against the
    plain backward in f32, at Flux-dev training's shape (512 text + 1024
    image tokens), Flux-schnell's (256 + 1024), a padded length and head dim
    64. Timed behind a sleep kernel: E and F alone, the pair as the backward
    runs them (F launched as E's programmatic dependent) and the whole
    backward route (rotation, dvec, E, F, pull-back), the pair and the route
    in turns with SDPA's backward; at L 1536 also the tail (288 units of one
    block an SM at 24 heads: 2.18 waves of 132 SMs): E and F with the last
    wave's units whole (no split), the pair with F launched after E's end,
    and E, F and the pair at 22 heads (264 units, two full waves)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    cases, failures = [], []
    for label, b, length, h, d, text in (("dev_L1536_rope", 1, 1536, 24, 128, 512),
                                         ("schnell_L1280_rope", 1, 1280, 24, 128, 256),
                                         ("L1000_rope_padding", 1, 1000, 24, 128, 256),
                                         ("d64_B2_L1024_norope", 2, 1024, 10, 64, None)):
        q, k, v, dout = (torch.randn((b, length, h, d), generator=g, device=dev).to(torch.bfloat16)
                         for _ in range(4))
        cos, sin = _flux_rope_tables(length, text) if text is not None else (None, None)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = fa.flash_attention(qg, kg, vg, cos, sin)
        got = torch.autograd.grad(out, (qg, kg, vg), dout)
        out = out.detach()
        # the plain backward in f32 on the same rotated bf16 q/k, lse and dvec
        _, lse = fa.flash_attention(q, k, v, cos, sin, return_lse=True)
        qr, kr = ((fa._rope_f32(x, cos, sin).to(x.dtype) if cos is not None else x).contiguous()
                  for x in (q, k))
        dvec = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, length).contiguous()
        ref = fb.flash_attention_bwd_reference(qr.float(), kr.float(), v.float(), dout.float(), lse,
                                               dvec, d ** -0.5)
        if cos is not None:
            ref = (fa._rope_f32(ref[0], cos, -sin), fa._rope_f32(ref[1], cos, -sin), ref[2])
        errs = [((x.float() - r).abs().max() / r.abs().max()).item() for x, r in zip(got, ref)]
        torch.cuda.synchronize()

        scale = d ** -0.5
        args = (qr, kr, v, dout, lse, dvec, scale)
        e_ms = time_ms_queued(lambda: fb.flash_attention_bwd_dq_cuda(*args))
        f_ms = time_ms_queued(lambda: fb.flash_attention_bwd_dkv_cuda(*args))
        plain_ms = time_ms(lambda: fb.flash_attention_bwd_reference(*args), iters=5, warmup=1)
        # yardstick: SDPA's backward on the pre-rotated q/k in (B, H, L, D)
        qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (qr, kr, v))
        os_ = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        dos = dout.transpose(1, 2).contiguous()
        turns = in_turns({
            "pair": lambda: fb.flash_attention_bwd(*args),
            "route": lambda: fa.flash_attention_backward(q, k, v, cos, sin, out, lse, dout, scale),
            "sdpa": lambda: torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True)})
        library_ms = statistics.mean(turns["sdpa"])
        pair_ms = statistics.mean(turns["pair"])
        lsq = b * h * length * length * d
        io = q.numel() * 2  # one (B, L, H, D) bf16 tensor
        e_bound = bound_ms(6 * lsq, 5 * io + 2 * b * h * length * 4)  # q k v dO in, dq out
        f_bound = bound_ms(8 * lsq, 6 * io + 2 * b * h * length * 4)  # q k v dO in, dk dv out
        pair_bound = bound_ms(14 * lsq, 7 * io + 2 * b * h * length * 4)
        rec = dict(case=label, max_rel_err=max(errs), max_abs_err=max(
            (x.float() - r).abs().max().item() for x, r in zip(got, ref)),
            dq_ms=e_ms, dkv_ms=f_ms, pair_ms=pair_ms, route_ms=statistics.mean(turns["route"]),
            plain_ms=plain_ms, library_ms=library_ms, turns_ms=turns,
            dq_bound_ms=e_bound[0], dq_bound_by=e_bound[1], dkv_bound_ms=f_bound[0],
            dkv_bound_by=f_bound[1], pair_bound_ms=pair_bound[0],
            dq_tflops=6 * lsq / e_ms / 1e9, dkv_tflops=8 * lsq / f_ms / 1e9, pair_tflops=14 * lsq / pair_ms / 1e9)
        log(f"[kernels-train] flash bwd {label}: max|Δ|/max|ref| dq {errs[0]:.3e} dk {errs[1]:.3e} "
            f"dv {errs[2]:.3e} (tol {FLASH_BWD_REL_TOL}) | E {e_ms:.4f} ms ({rec['dq_tflops']:.1f} TFLOP/s, "
            f"{100 * e_bound[0] / e_ms:.1f}% of the bound {e_bound[0]:.4f}) | F {f_ms:.4f} ms "
            f"({rec['dkv_tflops']:.1f} TFLOP/s, {100 * f_bound[0] / f_ms:.1f}% of the bound {f_bound[0]:.4f}) | "
            f"pair {pair_ms:.4f} ms ({rec['pair_tflops']:.1f} TFLOP/s, {100 * pair_bound[0] / pair_ms:.1f}% "
            f"of {pair_bound[0]:.4f}) | plain {plain_ms:.4f} ms | in turns: pair "
            f"{' '.join(f'{x:.4f}' for x in turns['pair'])}, route {' '.join(f'{x:.4f}' for x in turns['route'])}"
            f", SDPA backward {' '.join(f'{x:.4f}' for x in turns['sdpa'])} ms")
        if label == "dev_L1536_rope":
            # the tail: one block an SM, 288 blocks of 128 rows on 132 SMs
            sub = [x[:, :, :22].contiguous() for x in (qr, kr, v, dout)]
            sub += [x.reshape(b, h, length)[:, :22].reshape(b * 22, length).contiguous() for x in (lse, dvec)]
            sub_args = (*sub, scale)
            tail = in_turns({
                "pair": lambda: fb.flash_attention_bwd(*args),
                "serial": lambda: (fb.flash_attention_bwd_dq_cuda(*args),
                                   fb.flash_attention_bwd_dkv_cuda(*args))})
            tail.update(e_whole_ms=time_ms_queued(lambda: fb.flash_attention_bwd_dq_cuda(*args, split=False)),
                        f_whole_ms=time_ms_queued(lambda: fb.flash_attention_bwd_dkv_cuda(*args, split=False)),
                        e_h22_ms=time_ms_queued(lambda: fb.flash_attention_bwd_dq_cuda(*sub_args)),
                        f_h22_ms=time_ms_queued(lambda: fb.flash_attention_bwd_dkv_cuda(*sub_args)),
                        pair_h22_ms=time_ms_queued(lambda: fb.flash_attention_bwd(*sub_args)),
                        sms=torch.cuda.get_device_properties(0).multi_processor_count)
            rec["tail"] = tail
            log(f"[kernels-train] tail at L 1536 ({tail['sms']} SMs): E {e_ms:.4f}, F {f_ms:.4f} ms; the last "
                f"wave's units whole: E {tail['e_whole_ms']:.4f}, F {tail['f_whole_ms']:.4f} ms | pair (F as E's "
                f"dependent) {' '.join(f'{x:.4f}' for x in tail['pair'])} ms, F after E's end "
                f"{' '.join(f'{x:.4f}' for x in tail['serial'])} ms | 22 heads (264 units, 2 waves): E "
                f"{tail['e_h22_ms']:.4f}, F {tail['f_h22_ms']:.4f}, pair {tail['pair_h22_ms']:.4f} ms")
            del sub, sub_args
        if not max(errs) <= FLASH_BWD_REL_TOL:
            failures.append(f"flash bwd {label}: {errs}")
        cases.append(rec)
        del q, k, v, dout, qg, kg, vg, out, got, ref, qs, ks, vs, os_, args
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("flash backward disagrees with its plain version: " + "; ".join(failures))
    return {"flash_attention_bwd": cases}


def phase_kernels_w8a8():
    """Kernel G (fused W8A8 matmul) at every dense shape of a Flux-schnell
    512² request (G_SHAPES), each against its plain version, timed in turns
    with torch._int_mm on the quantized operands and with the "rows" route
    (H, the int8 dot, its scalings), its two launches (quantizer pass and
    GEMM) apart by profiler device time, and the request-weighted sums;
    kernel H (row quantizer) on the qkv input; A's int8 tiers at L 1280 with
    RoPE (D 128 and 64) and at a padded L 1000. Each against its plain
    version on the same bf16 inputs. G and its yardsticks take the weights
    as ops.quant stores them (K-contiguous)."""
    import torch

    from flux_generator_tpu_torch.ops import linear as tl
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm
    from flux_generator_tpu_torch.ops.quant import quantize_dense

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8642)
    results, failures = {}, []

    cases = []
    sums = dict(kernel=0.0, int_mm=0.0, rows=0.0, bound=0.0, quantizer=0.0, gemm=0.0)
    for name, m, k, n, per_request in G_SHAPES:
        label = f"{name}_{m}x{k}x{n}"
        p = quantize_dense({"kernel": torch.randn((k, n), generator=g, device=dev) / k ** 0.5})
        wq, ws = p["kernel_q"], p["kernel_scale"]
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        out = wm.w8a8_matmul(x, wq, ws)
        again = wm.w8a8_matmul(x, wq, ws)
        ref = wm.w8a8_matmul_reference(x, wq, ws)
        err = (out.float() - ref.float()).abs().max().item()
        # each tile folds its K blocks in order, as the plain version: its bits,
        # and the same bits from run to run
        if not (torch.equal(out, ref) and torch.equal(out, again)):
            failures.append(f"G {label}: equal to the plain version {torch.equal(out, ref)}, run to run "
                            f"{torch.equal(out, again)}")
        # yardsticks: torch._int_mm on the operands already quantized (row-quantized
        # x, the weight), the int8 product alone; and the "rows" route
        x_q = wm.quantize_rows_reference(x)[0]
        turns = in_turns({"kernel": lambda: wm.w8a8_matmul(x, wq, ws),
                          "int_mm": lambda: torch._int_mm(x_q, wq),
                          "rows": lambda: tl._w8a8(p, x, "rows")})
        ms, lib_ms, rows_ms = (statistics.mean(turns[key]) for key in ("kernel", "int_mm", "rows"))
        apart = device_ms_by_kernel(lambda: wm.w8a8_matmul(x, wq, ws))
        quant_ms = sum(v for kname, v in apart.items() if "quantize" in kname)
        gemm_ms = sum(v for kname, v in apart.items() if "quantize" not in kname)
        plain_ms = time_ms(lambda: wm.w8a8_matmul_reference(x, wq, ws), iters=3, warmup=1)
        # x, out bf16; weights int8; scales f32
        bound = bound_ms(2 * m * k * n, 2 * m * k + k * n + 4 * n + 2 * m * n, PEAK_INT8_OPS)
        # the quantizer pass: x read, x_q and its (row, K block) scales written
        quant_bound = bound_ms(3 * m * k, 2 * m * k + m * k + 4 * m * (k // wm.pick_bk(k)))
        for key, v in (("kernel", ms), ("int_mm", lib_ms), ("rows", rows_ms), ("bound", bound[0]),
                       ("quantizer", quant_ms), ("gemm", gemm_ms)):
            sums[key] += per_request * v
        log(f"[kernels-w8a8] G {label} ({per_request} a request): max|Δ| {err:.3e} (tol 0: bit for bit) | "
            f"in turns: kernel " + " ".join(f"{t:.4f}" for t in turns["kernel"])
            + f" ms ({2 * m * k * n / ms / 1e9:.1f} TOP/s, {100 * bound[0] / ms:.1f}% of its bound), "
            + "torch._int_mm " + " ".join(f"{t:.4f}" for t in turns["int_mm"])
            + " ms, rows route " + " ".join(f"{t:.4f}" for t in turns["rows"])
            + f" ms | apart (device time): quantizer {quant_ms:.4f} ms (bound {quant_bound[0]:.4f}, "
            f"{quant_bound[1]}), GEMM {gemm_ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms "
            f"({bound[1]})")
        cases.append(dict(case=label, launches_per_request=per_request, max_abs_err=err, ms=ms,
                          ms_in_turns=turns["kernel"], plain_ms=plain_ms, library_ms=lib_ms,
                          library_ms_in_turns=turns["int_mm"], rows_route_ms_in_turns=turns["rows"],
                          quantizer_ms=quant_ms, gemm_ms=gemm_ms, quantizer_bound_ms=quant_bound[0],
                          bound_ms=bound[0], bound_by=bound[1], bound_share=bound[0] / ms))
        del p, wq, ws, x, out, again, ref, x_q
    log(f"[kernels-w8a8] G request-weighted sums over {sum(s[4] for s in G_SHAPES)} launches: kernel "
        f"{sums['kernel']:.2f} ms (quantizer {sums['quantizer']:.2f} + GEMM {sums['gemm']:.2f}, device time) | "
        f"torch._int_mm {sums['int_mm']:.2f} ms | rows route {sums['rows']:.2f} ms | bound {sums['bound']:.2f} ms")
    results["w8a8_matmul"] = cases
    results["w8a8_matmul_request_sums_ms"] = sums

    m, k = 1024, 3072
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    q, sx = wm.quantize_rows(x)
    rq, rsx = wm.quantize_rows_reference(x)
    err = max((q.int() - rq.int()).abs().max().item(), (sx - rsx).abs().max().item())
    ms = time_ms(lambda: wm.quantize_rows(x))
    plain_ms = time_ms(lambda: wm.quantize_rows_reference(x))
    # bf16 read, int8 and f32 scales written; abs, max and a scaled round a value
    bound = bound_ms(3 * m * k, 2 * m * k + m * k + 4 * m)
    log(f"[kernels-w8a8] H 1024x3072: max|Δ| {err:.3e} (tol 0: the same correctly rounded f32 "
        f"operations) | kernel {ms:.4f} ms ({(3 * m * k + 4 * m) / ms / 1e6:.1f} GB/s) | plain "
        f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]})")
    if err != 0:
        failures.append(f"H: {err}")
    results["w8a8_quantize_rows"] = [dict(case="1024x3072", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=None, bound_ms=bound[0], bound_by=bound[1])]

    # A's int8 tiers: out by rel-L2 and lse by max|Δ| against the tier's plain
    # version, and every control (a function the tier must not be) has to
    # fail the same check, or the check could not tell the tier apart
    for tier in ("qk", "full"):
        tol_out, tol_lse = INT8_ATTN_TOL[tier]
        tier_cases = []
        for label, length, d, peaked in (("L1280_rope", 1280, 128, False),
                                         ("L1280_d64_rope", 1280, 64, False),
                                         ("L1000_rope_padding", 1000, 128, False),
                                         ("L1280_rope_peaked_outlier_v", 1280, 128, True)):
            h = 3072 // d
            q, k_, v = (torch.randn((1, length, h, d), generator=g, device=dev) for _ in range(3))
            if peaked:  # quantization dominates: logits 3x sharper, every 97th key's V 16x larger
                q = q * 3
                v[:, ::97] *= 16
            q, k_, v = (x.to(torch.bfloat16) for x in (q, k_, v))
            cos, sin = _flux_rope_tables(length, axes_dim=(16, 56, 56) if d == 128 else (8, 28, 28))
            out, lse = fa.flash_attention(q, k_, v, cos, sin, return_lse=True, int8=tier)
            ref, ref_lse = fa.flash_attention_reference(q, k_, v, cos, sin, int8=tier)

            def dist(o, ls):
                return ((o.float() - ref.float()).norm() / ref.float().norm()).item(), \
                    (ls - ref_lse).abs().max().item()

            err_out, err_lse = dist(out, lse)
            err = max((out.float() - ref.float()).abs().max().item(), err_lse)
            controls = {"bf16": fa.flash_attention_reference(q, k_, v, cos, sin)}
            if tier == "full":
                controls["qk"] = fa.flash_attention_reference(q, k_, v, cos, sin, int8="qk")
                controls["streamed"] = fa.streamed_full_reference(q, k_, v, cos, sin)
            control_dist = {name: dist(*c) for name, c in controls.items()}
            ms = time_ms(lambda: fa.flash_attention(q, k_, v, cos, sin, int8=tier))
            plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k_, v, cos, sin, int8=tier),
                               iters=5, warmup=1)
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (
                fa._rope_f32(q, cos, sin).to(q.dtype), fa._rope_f32(k_, cos, sin).to(q.dtype), v))
            sdpa_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs))
            half = 2 * length * length * d * h  # one of the two products
            parts = ([(half, PEAK_INT8_OPS), (half, PEAK_BF16_FLOPS)] if tier == "qk"
                     else [(2 * half, PEAK_INT8_OPS)])
            # q, k, v, out bf16, the two tables, lse f32
            bound = bound_ms_parts(parts, 4 * q.numel() * 2 + 2 * cos.numel() * 2 + length * h * 4)
            log(f"[kernels-w8a8] A-{tier} {label}: out rel-L2 {err_out:.3e} (tol {tol_out}), lse max|Δ| "
                f"{err_lse:.3e} (tol {tol_lse}), max|Δ| {err:.3e} | controls (out rel-L2, lse max|Δ|): "
                + ", ".join(f"{n} {o:.3e} {ls:.3e}" for n, (o, ls) in control_dist.items())
                + f" | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | SDPA bf16 forward {sdpa_ms:.4f} ms "
                f"(for scale) | bound {bound[0]:.4f} ms ({bound[1]})")
            if not (err_out <= tol_out and err_lse <= tol_lse):
                failures.append(f"A-{tier} {label}: out rel-L2 {err_out}, lse {err_lse}")
            passed = [n for n, (o, ls) in control_dist.items() if o <= tol_out and ls <= tol_lse]
            if passed:
                failures.append(f"A-{tier} {label}: controls {passed} pass the check")
            tier_cases.append(dict(case=label, max_abs_err=err, out_rel_l2=err_out, lse_max_abs_err=err_lse,
                                   control_out_rel_l2_lse=control_dist, ms=ms, plain_ms=plain_ms,
                                   library_ms=None, sdpa_bf16_ms=sdpa_ms, bound_ms=bound[0],
                                   bound_by=bound[1]))
            del q, k_, v, out, ref, qs, ks, vs, controls
        results[f"flash_attention_int8_{tier}"] = tier_cases
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("W8A8 kernels disagree with their plain versions: " + "; ".join(failures))
    return results


def _train_setup(out_dir: str, *extra: str):
    """The main-train configuration: parsed trainer args (TRAIN_ARGS, then
    `extra`), the Flux-dev pipeline that the trainer's random_pipeline
    builds from them on the card, its build time in s, and two seeded
    640x576 uint8 images with their prompts."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.training.dreambooth import build_parser, random_pipeline

    args = build_parser().parse_args([out_dir, *TRAIN_ARGS, "--output-dir", out_dir, *extra])
    t0 = time.perf_counter()
    pipe = random_pipeline(args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(77)
    dataset = [(rng.integers(0, 256, (576, 640, 3), dtype=np.uint8), p) for p in TRAIN_PROMPTS]
    return args, pipe, init_s, dataset


def phase_main_train():
    """DreamBooth LoRA training of Flux-dev at full width (19 + 38 blocks,
    hidden 3072, T5-XXL int4 g128, CLIP-L, VAE) on random weights: 3
    optimizer steps of 4 micro-steps through training.dreambooth.train with
    the base in int8, on two seeded 640x576 images and two prompts."""
    import tempfile

    import numpy as np
    import torch

    from flux_generator_tpu_torch.io.params import tree_leaves
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.training.checkpoints import load_adapter_file
    from flux_generator_tpu_torch.training.dreambooth import train
    from flux_generator_tpu_torch.training.lora import extract_lora

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        args, pipe, init_s, dataset = _train_setup(out_dir)
        log(f"[main-train] random init + T5 int4 {init_s:.2f} s, resident "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        micro = args.iterations * args.grad_accumulate
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.rope_launches = fb.dq_launches = fb.dkv_launches = im.launches = 0
        trace = {}
        t0 = time.perf_counter()
        train(args, pipeline=pipe, dataset=dataset, trace=trace)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches, "flash_attention_rope": fa.rope_launches,
                    "flash_attention_bwd_dq": fb.dq_launches, "flash_attention_bwd_dkv": fb.dkv_launches,
                    "int4_matmul": im.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = trace["micro_step_s"]
        log(f"[main-train] train {total_s:.3f} s: encode dataset {trace['encode_s']:.4f} s "
            f"({len(dataset)} images x {args.num_augmentations} augmentations, {len(dataset)} prompts)"
            f" | first micro-step {steps[0]:.4f} s | later micro-steps "
            + " ".join(f"{x:.4f}" for x in steps[1:]) + f" s | peak {peak:.2f} GiB")
        log(f"[main-train] losses " + " ".join(f"{x:.5f}" for x in trace["losses"]))
        per_step = {k: v / micro for k, v in launches.items() if k != "int4_matmul"}
        log(f"[main-train] launches over {micro} micro-steps: {launches} | per micro-step "
            f"{per_step} | int4 per prompt {launches['int4_matmul'] / len(dataset)}")

        cfg = pipe.flow_cfg
        blocks = cfg.depth + cfg.depth_single_blocks
        # A and its pre-pass twice a block (the forward and its recompute), the
        # pre-pass twice more in the backward (the rotation and the pull-back)
        want = {"flash_attention": 2 * blocks * micro, "flash_attention_rope": 4 * blocks * micro,
                "flash_attention_bwd_dq": blocks * micro, "flash_attention_bwd_dkv": blocks * micro,
                "int4_matmul": 24 * 7 * len(dataset)}
        if launches != want:
            raise AssertionError(f"launch counts {launches}, want {want}")
        if len(steps) != micro or not np.isfinite(trace["losses"]).all():
            raise AssertionError(f"micro-steps {len(steps)} (want {micro}), losses {trace['losses']}")
        lora = extract_lora(pipe.params["flow"])
        lora_b = [t for path, t in _named(lora) if path.endswith("lora_b")]
        if not all(bool(t.any()) for t in lora_b):
            raise AssertionError("some lora_b is still zero after training")
        trained = [t.detach().clone() for t in tree_leaves(lora)]
        final = pathlib.Path(out_dir) / "final_adapters.safetensors"
        written = sorted(p.name for p in pathlib.Path(out_dir).iterdir())
        load_adapter_file(pipe, final)
        reread = tree_leaves(extract_lora(pipe.params["flow"]))
        same = len(reread) == len(trained) and all(torch.equal(a, b) for a, b in zip(reread, trained))
        log(f"[main-train] written {written}; adapter re-read equal to the trained LoRA: {same}; "
            f"{len(trained)} LoRA tensors, {sum(t.numel() for t in trained) / 1e6:.2f} M params")
        if not same or "0000003_adapters.safetensors" not in written:
            raise AssertionError("the adapter files were not written or do not read back")
    return dict(init_s=init_s, train_s=total_s, encode_s=trace["encode_s"], micro_step_s=steps,
                losses=trace["losses"], peak_gib=peak, launches=launches,
                launches_per_micro_step=per_step)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def phase_small_train():
    """A small Flux-dev config (head dim 128, 1 + 1 blocks, int8 base, LoRA
    rank 4 with nonzero lora_b): the training loss and its LoRA gradients at
    fixed numpy x0/t/eps, on the card in bf16 with the kernels against the
    CPU in f32 with the plain versions."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.io.params import tree_leaves
    from flux_generator_tpu_torch.models.flux.autoencoder import tiny_ae_config
    from flux_generator_tpu_torch.models.flux.model import FluxConfig, init_flux
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
    from flux_generator_tpu_torch.training.lora import apply_lora_to_flux, extract_lora, merge_lora

    cfg = FluxConfig(in_channels=64, vec_in_dim=64, context_in_dim=256, hidden_size=256, mlp_ratio=2.0,
                     num_heads=2, depth=1, depth_single_blocks=1, guidance_embed=True)
    g = torch.Generator().manual_seed(15)
    flow = apply_lora_to_flux(init_flux(g, cfg), rank=4, generator=g)
    rng = np.random.default_rng(16)
    for path, t in _named(extract_lora(flow)):
        if path.endswith("lora_b"):
            t.copy_(torch.from_numpy(0.05 * rng.standard_normal(t.shape).astype(np.float32)))
    flow = quantize_tree(flow, lambda p: True)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 16, 16)).astype(np.float32))
    # a timestep that bf16 holds exactly: the flow takes t in the working dtype,
    # and 0.6 → 0.5977 would move the timestep embedding's fast sinusoids
    t = torch.tensor([0.625], dtype=torch.float32)
    eps = torch.from_numpy(rng.standard_normal((1, 64, 64)).astype(np.float32))
    t5 = torch.from_numpy(rng.standard_normal((1, 32, 256)).astype(np.float32))
    clip = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    guidance = torch.tensor([3.0])
    outs = {}
    counts0 = (fa.launches, fb.dq_launches, fb.dkv_launches)
    flows = {"cpu": flow, "gpu": _to_device(flow, "cuda", torch.bfloat16)}
    for name, dev, dt in (("cpu", "cpu", torch.float32), ("gpu", "cuda", torch.bfloat16)):
        f = flows[name]
        pipe = FluxPipeline("flux-dev", {"flow": f}, cfg, tiny_ae_config(z_channels=16), None, None,
                            dtype=dt)
        lora = extract_lora(f)
        leaves = tree_leaves(lora)
        for p in leaves:
            p.requires_grad_(True)
        loss = pipe._training_loss_at(merge_lora(f, lora), x0.to(dev, dt), t.to(dev), eps.to(dev, dt),
                                      t5.to(dev, dt), clip.to(dev, dt), guidance.to(dev, dt))
        grads = torch.autograd.grad(loss, leaves)
        outs[name] = (loss.item(), torch.cat([gr.float().cpu().reshape(-1) for gr in grads]))
    counts = tuple(c - c0 for c, c0 in zip((fa.launches, fb.dq_launches, fb.dkv_launches), counts0))
    loss_err = abs(outs["gpu"][0] - outs["cpu"][0]) / abs(outs["cpu"][0])
    grad_err = ((outs["gpu"][1] - outs["cpu"][1]).norm() / outs["cpu"][1].norm()).item()
    log(f"[small-train] loss cpu {outs['cpu'][0]:.6f} gpu {outs['gpu'][0]:.6f} (rel {loss_err:.3e}) | "
        f"LoRA grads rel-L2 {grad_err:.3e} (tol {SMALL_REL_TOL}) | launches A/E/F on the card {counts}")
    if counts != (4, 2, 2):
        raise AssertionError(f"small training config did not run the kernels on the card: {counts}")
    if not (loss_err <= SMALL_REL_TOL and grad_err <= SMALL_REL_TOL):
        raise AssertionError("the card's training step disagrees with the CPU reference")
    return dict(loss_rel_err=loss_err, lora_grad_rel_l2=grad_err)


def _kernel_group(name: str) -> str:
    """Coarse group of a CUDA kernel by its name, for the profiles."""
    for key, group in (("flash_fwd_sm90", "A flash forward"), ("rope_rotate", "A RoPE pre-pass"),
                       ("flash_fwd_kernel", "A int8 flash forward"), ("flash_bwd_dq", "E flash dQ"),
                       ("flash_bwd_dkv", "F flash dK/dV"), ("int4_matmul", "B int4 matmul"),
                       ("w8a8_gemm_sm90", "G W8A8 matmul"), ("quantize_blocks_kernel", "G quantizer pass"),
                       ("quantize_rows_kernel", "H row quantizer"),
                       ("v_col_amax", "A int8 V column pre-pass")):
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMMs (cuBLAS)"
    if "norm" in low:
        return "norms"
    if "reduce" in low:
        return "reductions"
    if any(k in low for k in ("elementwise", "copy", "cast", "fill")):
        return "elementwise, casts, copies"
    return "other"


def _profile_record(prof, per: int, wall_ms: float, tag: str, unit: str, note: str) -> dict:
    """Device time by kernel group and by kernel, and the device's busy time
    (the union of the kernels' intervals), each per `unit` (the profiled
    window holds `per` of them), logged under [tag] and returned."""
    from torch.autograd import DeviceType

    kernels, spans = {}, []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
            kernels.setdefault(ev.name, [0.0, 0])
            kernels[ev.name][0] += ev.device_time_total / 1e3 / per
            kernels[ev.name][1] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    busy_us, last = 0.0, None
    for start, end in sorted(spans):  # union of the kernels' intervals
        if last is None or start > last:
            busy_us += end - start
            last = end
        elif end > last:
            busy_us += end - last
            last = end
    busy_ms = busy_us / 1e3 / per
    groups = {}
    for kname, (ms, _) in kernels.items():
        grp = _kernel_group(kname)
        groups[grp] = groups.get(grp, 0.0) + ms
    kernel_ms = sum(groups.values())
    log(f"[{tag}] {unit} wall {wall_ms:.1f} ms with the profiler on (mean of {per}, {note}) | "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% | kernel time {kernel_ms:.1f} ms | "
        f"{sum(n for _, n in kernels.values()) // per} kernel launches a {unit}")
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   {grp}: {ms:.2f} ms ({100 * ms / kernel_ms:.1f}%)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for kname, (ms, n) in top:
        log(f"[{tag}]   {ms:8.2f} ms {n // per:6d}x  {kname[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernel_ms=kernel_ms, groups=groups,
                top=[dict(name=k, ms=ms, calls=n // per) for k, (ms, n) in top])


def phase_profile_train():
    """One optimizer step of Flux-dev training (the main-train configuration:
    grad_accumulate micro-steps, the last with the Adam update) under
    torch.profiler, through the step function that training.dreambooth.train
    runs (make_train_step), after a warm-up through train itself: device time
    by kernel group and by kernel, and the device's busy share of the wall,
    per micro-step. Writes chiprun_out/profile_train.json."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from flux_generator_tpu_torch.io.params import tree_leaves
    from flux_generator_tpu_torch.training.dreambooth import build_optimizer, make_train_step, train
    from flux_generator_tpu_torch.training.lora import extract_lora
    from flux_generator_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        args, pipe, _, dataset = _train_setup(out_dir, "--checkpoint-every", "0", "--iterations", "1")
        train(args, pipeline=pipe, dataset=dataset)  # warm-up; applies LoRA and the int8 base

    # the trained flow tree carries the LoRA leaves, which train left requiring grad
    flow = pipe.params["flow"]
    lora = extract_lora(flow)
    optimizer = build_optimizer(args.learning_rate, args.warmup_steps, args.iterations)
    step_fn = make_train_step(pipe, optimizer, flow, args.grad_accumulate)
    trainer = Trainer(pipe, dataset, resolution=args.resolution,
                      num_augmentations=args.num_augmentations)
    trainer.encode_dataset()
    batches = trainer.iterate(args.batch_size)
    guidance = torch.full((args.batch_size,), args.guidance, dtype=pipe.dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    state = {"opt": optimizer.init(lora), "accum": None}
    micro_steps = args.grad_accumulate
    if not all(p.requires_grad for p in tree_leaves(lora)):
        raise AssertionError("the LoRA leaves do not require grad after train")

    def micro_step(i):
        x0, t5f, clipf = next(batches)
        loss, _, state["opt"], state["accum"] = step_fn(
            lora, state["opt"], state["accum"], g, x0, t5f, clipf, guidance,
            is_first=i == 0, should_step=i == micro_steps - 1)
        return float(loss)  # waits for the device, as train does

    for i in range(micro_steps):  # one whole step to warm the update path too
        micro_step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(micro_steps):
            micro_step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / micro_steps

    record = _profile_record(prof, micro_steps, wall_ms, "profile-train",
                             "micro-step", "the last with the Adam update")
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_train.json").write_text(json.dumps(record, indent=1))
    return record


def main() -> int:
    smi, name = phase_device()
    if sys.argv[1:] == ["--profile-train"]:
        phase_build()
        phase_profile_train()
        return 0
    import gc

    import torch

    from flux_generator_tpu_torch.ops.kernels import bare_dot as bd
    from flux_generator_tpu_torch.ops.kernels import chain_bisect as cb
    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import lstm as lk
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm

    def run(phase):
        out = phase()
        gc.collect()  # each phase's pipeline goes before the next is built
        torch.cuda.empty_cache()
        return out

    build_info = phase_build()
    kernels = run(phase_kernels)
    kernels.update(run(phase_kernels_musicgen))
    kernels.update(run(phase_kernels_musicgen_f8))
    kernels.update(run(phase_kernels_chain))
    kernels.update(run(lambda: phase_kernels_chain_bisect(kernels["decode_chain"][0])))
    kernels.update(run(phase_kernels_train))
    kernels.update(run(phase_kernels_w8a8))
    kernels.update(run(phase_kernels_bare_dot))
    streamed = run(phase_kernels_flash_streamed)
    kernels.update(flash_attention_streamed=streamed["flash_attention_streamed"])
    main_run, pipe, latents = phase_main()
    main_w8a8 = run(lambda: phase_main_w8a8(pipe, latents))
    main_2048 = run(lambda: phase_main_2048(pipe))
    del pipe, latents
    main_music, pipe = phase_main_musicgen()
    main_serve = run(lambda: phase_main_musicgen_serve(pipe))
    main_long = run(lambda: phase_main_musicgen_long(pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    main_train = run(phase_main_train)
    small = run(phase_small)
    small_tiled = run(phase_small_tiled)
    small_w8a8 = run(phase_small_w8a8)
    small_music = run(phase_small_musicgen)
    small_train = run(phase_small_train)

    entries = []
    for mod, key, main_case, path in (
            (fa, "flash_attention", "L1280_rope", main_run),
            (fa, "flash_attention_rope", "L1280_rope", main_run),
            (im, "int4_matmul", "qkvo_4096x4096_g128", main_run),
            (lk, "lstm", "d1024_T497_bf16", main_music),
            (ds, "decode_step", "int8_B2_W500_off250", main_music)):
        case = next(c for c in kernels[key] if c["case"] == main_case)
        entries.append(dict(name=key, route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
                            launches=path["launches"][key],
                            max_abs_err=max(c["max_abs_err"] for c in kernels[key]),
                            ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                            bound_by=case["bound_by"], library_ms=case["library_ms"]))
        if key == "int4_matmul":
            entries[-1]["bound_share"] = case["bound_share"]
    bwd = kernels["flash_attention_bwd"]
    case = next(c for c in bwd if c["case"] == "dev_L1536_rope")
    for key, which, replaces in (("flash_attention_bwd_dq", "dq", fb.REPLACES_DQ),
                                 ("flash_attention_bwd_dkv", "dkv", fb.REPLACES_DKV)):
        # the plain backward and SDPA's backward compute dq, dk and dv together
        entries.append(dict(name=key, route="cuda", source=fb.SOURCE, replaces=replaces,
                            launches=main_train["launches"][key],
                            max_abs_err=max(c["max_abs_err"] for c in bwd),
                            ms=case[f"{which}_ms"], plain_ms=case["plain_ms"],
                            bound_ms=case[f"{which}_bound_ms"], bound_by=case[f"{which}_bound_by"],
                            library_ms=case["library_ms"]))
    for key, source, replaces, main_case in (
            ("w8a8_matmul", wm.SOURCE, wm.REPLACES, "qkv_1024x3072x9216"),
            ("w8a8_quantize_rows", wm.SOURCE, wm.REPLACES_QUANTIZE, "1024x3072"),
            ("flash_attention_int8_qk", fa.INT8_SOURCE, fa.REPLACES, "L1280_rope"),
            ("flash_attention_int8_full", fa.INT8_SOURCE, fa.REPLACES, "L1280_rope")):
        case = next(c for c in kernels[key] if c["case"] == main_case)
        entries.append(dict(name=key, route="cuda", source=source, replaces=replaces,
                            launches=main_w8a8["launches"][key],
                            max_abs_err=max(c["max_abs_err"] for c in kernels[key]),
                            ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                            bound_by=case["bound_by"], library_ms=case["library_ms"]))
        if key == "w8a8_matmul":
            entries[-1]["bound_share"] = case["bound_share"]
    for key, source, replaces, launches in (
            ("decode_step_f8", ds.SOURCE, ds.REPLACES_E4M3,
             main_serve["launches"]["decode_step_f8"] + main_long["launches"]["decode_step_f8"]),
            ("decode_chain", dc.SOURCE, dc.REPLACES, kernels["decode_chain"][0]["launches"])):
        # decode_step_f8: the four coalesced requests' shape (B 8, W 2048,
        # offset 1900); decode_chain: its launches are the probe entry point's
        case = kernels[key][1] if key == "decode_step_f8" else kernels[key][0]
        entries.append(dict(name=key, route="cuda", source=source, replaces=replaces, launches=launches,
                            max_abs_err=max(c["max_abs_err"] for c in kernels[key]),
                            ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                            bound_by=case["bound_by"], library_ms=case["library_ms"]))
    probe_launches = streamed["prof_attn_int8"]["launches"]
    for mode in bd.MODES:
        case = kernels["bare_dot"][mode]
        entries.append(dict(name="bare_dot" if mode == "bf16" else f"bare_dot_{mode}", route="cuda",
                            source=bd.SOURCE, replaces=bd.REPLACES, launches=probe_launches["bare_dot"][mode],
                            max_abs_err=case["max_abs_err"], ms=case["ms"], plain_ms=case["plain_ms"],
                            bound_ms=case["bound_ms"], bound_by=case["bound_by"], library_ms=case["library_ms"],
                            bound_share=case["bound_share"]))
    case = kernels["flash_attention_streamed"]["full_streamed"]
    entries.append(dict(name="flash_attention_int8_full_streamed", route="cuda", source=fa.INT8_SOURCE,
                        replaces=fa.REPLACES_STREAMED_FULL,
                        launches=probe_launches["flash_attention_int8_full_streamed"],
                        max_abs_err=case["max_abs_err"], ms=case["ms"], plain_ms=case["plain_ms"],
                        bound_ms=case["bound_ms"], bound_by=case["bound_by"], library_ms=case["library_ms"]))
    bisect = kernels["chain_bisect"]
    # the full rung (every extra) at the script's 8 rows; its launches are the
    # probe entry point's
    case = next(c for c in bisect["cases"] if c["rows"] == 8 and c["extras"] == cb.RUNGS[-1])
    entries.append(dict(name="chain_bisect", route="cuda", source=cb.SOURCE, replaces=cb.REPLACES,
                        launches=bisect["launches"], max_abs_err=max(c["max_abs_err"] for c in bisect["cases"]),
                        ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                        bound_by=case["bound_by"], library_ms=case["library_ms"]))
    unlaunched = [e["name"] for e in entries if e["launches"] <= 0]
    if unlaunched:
        raise AssertionError(f"kernels that their paths never launched: {unlaunched}")
    record = dict(device=smi, build=build_info, kernels=kernels, prof_attn_int8=streamed["prof_attn_int8"],
                  main=main_run,
                  main_w8a8=main_w8a8, main_2048=main_2048,
                  main_musicgen=main_music, main_musicgen_serve=main_serve, main_musicgen_long=main_long,
                  main_train=main_train, small=small, small_tiled=small_tiled, small_w8a8=small_w8a8,
                  small_musicgen=small_music, small_train=small_train)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
