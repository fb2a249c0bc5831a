#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flux_generator_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. device         — the card's name and power limit; no CUDA device is an error.
  2. build          — compile the four CUDA kernels from csrc/ with nvcc, all
                      at once, with the ptxas report of each.
  3. kernels        — flash attention (A) and the int4 matmul (B) against their
                      plain PyTorch versions at the shapes of the Flux-schnell
                      512² path, with times of both.
  4. kernels-music  — the LSTM (C) and the fused decode step (D) against their
                      plain versions at MusicGen-medium shapes, with times.
  5. main           — Flux-schnell at full width on random weights (flow int8
                      per channel, T5-XXL int4 g=128), three 512², 4-step
                      requests through FluxPipeline.generate_images; checks the
                      images, the latents and the kernels' launch counts.
  6. main-musicgen  — MusicGen-medium at full width on random weights (decoder
                      and T5-base int8 per channel, EnCodec f32), three
                      500-step requests through MusicGenPipeline.generate;
                      checks the waveforms, the codes and the launch counts.
  7. small          — a small Flux config run on the card (bf16, kernels) and on
                      the CPU (f32, plain versions) from the same weights and noise.
  8. small-musicgen — a small MusicGen config (ffn = 4h, head dim 64) on the card
                      and on the CPU: teacher-forced logits and a decoded waveform.
The last line printed is {"ok": true, "device": {...}}; a fuller record goes
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

FLASH_TOL = 2e-2  # bf16 P·V and bf16 output against the f32 plain version
INT4_REL_TOL = 1e-2  # of max|ref|: the bf16 output rounding is 2^-9 relative
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


def log(*args):
    print(*args, flush=True)


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
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    mods = {"flash_attention": fa, "int4_matmul": im, "lstm": lk, "decode_step": ds}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, all at once
        futures = {name: pool.submit(_build.load, name, mod._SIGNATURES) for name, mod in mods.items()}
        for fut in futures.values():
            fut.result()
    log(f"[build] all kernels: {time.perf_counter() - t0:.2f} s")
    for name in mods:
        nvcc_s, report = _build.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {nvcc_s:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def _flux_rope_tables(length: int):
    """cos/sin (1, length, 64) in bf16 from the real Flux ids: 256 text
    tokens (id 0) then the 512² image's 32x32 patch grid."""
    import torch

    from flux_generator_tpu_torch.ops.rope import multi_axis_rope
    from flux_generator_tpu_torch.pipelines.flux import latent_ids

    dev = torch.device("cuda")
    ids = torch.cat([torch.zeros((1, 256, 3), dtype=torch.int64, device=dev),
                     latent_ids(1, SIZE // 8, SIZE // 8, device=dev)], dim=1)[:, :length]
    cos, sin = multi_axis_rope(ids, [16, 56, 56], 10000.0)
    return cos.to(torch.bfloat16).contiguous(), sin.to(torch.bfloat16).contiguous()


def phase_kernels():
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.quant import quantize_dense

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    flash = []
    for label, length, rope in (("L1280_rope", 1280, True), ("L1000_rope_padding", 1000, True),
                                ("L1280_norope", 1280, False)):
        q, k, v = (torch.randn((1, length, 24, 128), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        cos, sin = _flux_rope_tables(length) if rope else (None, None)
        out, lse = fa.flash_attention(q, k, v, cos, sin, return_lse=True)
        f32 = (lambda t: None if t is None else t.float())
        ref, ref_lse = fa.flash_attention_reference(f32(q), f32(k), f32(v), f32(cos), f32(sin))
        err = max((out.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        ms = time_ms(lambda: fa.flash_attention(q, k, v, cos, sin))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, cos, sin))
        gflop = 4 * length * length * 128 * 24 / 1e9
        log(f"[kernels] flash {label}: max|Δ| {err:.3e} (tol {FLASH_TOL}) | kernel {ms:.4f} ms "
            f"({gflop / ms:.1f} TFLOP/s) | plain {plain_ms:.4f} ms")
        if not err <= FLASH_TOL:
            raise AssertionError(f"flash {label} disagrees with its plain version: {err}")
        flash.append(dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    results["flash_attention"] = flash

    int4 = []
    for label, k_dim, n_dim, gs in (("qkvo_4096x4096_g128", 4096, 4096, 128),
                                    ("wi_4096x10240_g128", 4096, 10240, 128),
                                    ("wo_10240x4096_g128", 10240, 4096, 128),
                                    ("4096x4096_per_channel", 4096, 4096, None)):
        w = torch.randn((k_dim, n_dim), generator=g, device=dev) / k_dim ** 0.5
        p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
        del w
        x = torch.randn((256, k_dim), generator=g, device=dev).to(torch.bfloat16)
        out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
        ref = im.int4_matmul_reference(x.float(), p["kernel_q4"], p["kernel_scale"])
        err = (out.float() - ref).abs().max().item()
        tol = INT4_REL_TOL * ref.abs().max().item()
        ms = time_ms(lambda: im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"]))
        plain_ms = time_ms(lambda: im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"]))
        gflop = 2 * 256 * k_dim * n_dim / 1e9
        log(f"[kernels] int4 M=256 {label}: max|Δ| {err:.3e} (tol {tol:.3e}) | kernel {ms:.4f} ms "
            f"({gflop / ms:.1f} TFLOP/s) | plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"int4 {label} disagrees with its plain version: {err} > {tol}")
        int4.append(dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    results["int4_matmul"] = int4
    torch.cuda.synchronize()
    return results


class _FixedClipTokens:
    """Stand-in CLIP tokenizer where `regex` is missing: the fixed (1, 77)
    array the JAX bench feeds (bench.py:398-399)."""

    def encode(self, text):
        return [[1] * 77]


def _tokenizers():
    from flux_generator_tpu_torch.io.registry import FLUX_T5_MAX_LENGTH
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer

    t5 = load_t5_tokenizer(ROOT / "tests/assets/spiece/t5_like.model",
                           max_length=FLUX_T5_MAX_LENGTH["flux-schnell"])
    try:
        clip = load_clip_tokenizer(ROOT / "tests/assets/clip_tokenizer/vocab.json",
                                   ROOT / "tests/assets/clip_tokenizer/merges.txt")
    except ImportError:
        return t5, _FixedClipTokens(), "fixed (1, 77) token array (no regex module)"
    return t5, clip, "CLIP BPE test asset (tests/assets/clip_tokenizer)"


def phase_main():
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

    fa.launches = 0
    im.launches = 0
    requests, images = [], []
    for seed, prompt in PROMPTS:
        torch.cuda.reset_peak_memory_stats()
        fa0, im0 = fa.launches, im.launches
        trace = {}
        t0 = time.perf_counter()
        img = pipe.generate_images(prompt, num_steps=STEPS, latent_size=latent, seed=seed,
                                   as_uint8=True, trace=trace)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        flash_n, int4_n = fa.launches - fa0, im.launches - im0
        finite = bool(torch.isfinite(trace["latent"]).all())
        rec = dict(seed=seed, latency_s=latency, conditioning_s=trace["conditioning_s"],
                   denoise_s=trace["denoise_s"], decode_s=trace["decode_s"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, flash_launches=flash_n,
                   int4_launches=int4_n, shape=list(img.shape), dtype=str(img.dtype),
                   latent_finite=finite)
        log(f"[main] request seed={seed}: {latency:.4f} s (conditioning {rec['conditioning_s']:.4f}"
            f" + denoise {rec['denoise_s']:.4f} + decode {rec['decode_s']:.4f}) | peak "
            f"{rec['peak_gib']:.2f} GiB | launches flash {flash_n} int4 {int4_n} | "
            f"{tuple(img.shape)} {img.dtype} | latent finite {finite}")
        if tuple(img.shape) != (1, SIZE, SIZE, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"image {tuple(img.shape)} {img.dtype}")
        if not finite:
            raise AssertionError("final latent is not finite")
        if flash_n != 57 * STEPS or int4_n != 24 * 7:
            raise AssertionError(f"launch counts flash {flash_n} (want {57 * STEPS}), "
                                 f"int4 {int4_n} (want {24 * 7})")
        requests.append(rec)
        images.append(img)
    if any(torch.equal(images[0], other) for other in images[1:]):
        raise AssertionError("requests with different seeds gave identical images")
    return dict(init_s=init_s, quantize_s=quant_s, setup_peak_gib=setup_peak,
                resident_gib=resident, clip_tokens=clip_source, requests=requests,
                launches={"flash_attention": fa.launches, "int4_matmul": im.launches})


def _to_device(tree, device, dtype):
    """Move a param tree; floating leaves take `dtype` except the f32
    quantization scales."""
    if isinstance(tree, dict):
        return {k: (v.to(device) if k == "kernel_scale" else _to_device(v, device, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device, dtype) for v in tree]
    return tree.to(device, dtype) if tree.is_floating_point() else tree.to(device)


def phase_small():
    """A small Flux config (head dim 128, T5 width 256) on the card in bf16
    with the kernels, against the CPU in f32 with the plain versions."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.models.clip.text import init_clip_text, tiny_clip_config
    from flux_generator_tpu_torch.models.flux.autoencoder import init_autoencoder, tiny_ae_config
    from flux_generator_tpu_torch.models.flux.model import FluxConfig, init_flux
    from flux_generator_tpu_torch.models.t5.t5 import T5Config, init_t5_encoder
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline, latent_ids, pack_latents

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
    cpu = FluxPipeline("flux-schnell", params, flow_cfg, ae_cfg, clip_cfg, t5_cfg, dtype=torch.float32)
    gpu = FluxPipeline("flux-schnell", _to_device(params, "cuda", torch.bfloat16), flow_cfg, ae_cfg,
                       clip_cfg, t5_cfg, dtype=torch.bfloat16)

    rng = np.random.default_rng(6)
    t5_tok = torch.from_numpy(rng.integers(1, 64, (1, 64)))
    clip_tok = torch.from_numpy(rng.integers(1, 64, (1, 16)))
    noise = torch.from_numpy(rng.standard_normal((1, 16, 16, 16)).astype(np.float32))
    outs = {}
    fa0, im0 = fa.launches, im.launches
    for name, pipe in (("cpu", cpu), ("gpu", gpu)):
        dev = pipe.device
        txt, txt_ids, vec = pipe.prepare_conditioning(1, t5_tok.to(dev), clip_tok.to(dev))
        x_t = pack_latents(noise.to(dev, pipe.dtype))
        lat = pipe.denoise_latents(x_t, latent_ids(1, 16, 16, device=dev), txt, txt_ids, vec, STEPS, 0.0)
        outs[name] = (lat.float().cpu(), pipe.decode(lat, (16, 16)).float().cpu())

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    lat_err = rel(outs["gpu"][0], outs["cpu"][0])
    img_err = rel(outs["gpu"][1], outs["cpu"][1])
    log(f"[small] latent rel-L2 {lat_err:.3e}, image rel-L2 {img_err:.3e} (tol {SMALL_REL_TOL})")
    if fa.launches - fa0 != 2 * STEPS or im.launches - im0 != 2 * 7:
        raise AssertionError("small config did not run the kernels on the card")
    if not (lat_err <= SMALL_REL_TOL and img_err <= SMALL_REL_TOL):
        raise AssertionError("the card's run disagrees with the CPU reference")
    return dict(latent_rel_l2=lat_err, image_rel_l2=img_err)


def phase_kernels_musicgen():
    """Kernels C and D against their plain versions at MusicGen-medium shapes:
    the EnCodec LSTM (d = 1024, T = 497 frames, B = 1) and the 48-layer decode
    step (H = 1536, 24 heads, int8 and bf16 weights, windows of 8 to 2048
    rows, the CFG batch of 2 and a batch of 8 with cond_len masks)."""
    import torch

    from flux_generator_tpu_torch.io.registry import MUSICGEN_MEDIUM_CONFIG as cfg
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
        log(f"[kernels] lstm {label}: max|Δ| {err:.3e} (tol {tol}) | kernel {ms:.4f} ms "
            f"({ms * 1e3 / t:.2f} us/step) | plain {plain_ms:.4f} ms")
        if not err <= tol:
            failures.append(f"lstm {label}: {err} > {tol}")
        lstm_cases.append(dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms))
    results["lstm"] = lstm_cases

    L, H, heads, s_text = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads, 16
    n = L * ds.CPL
    ln = torch.stack([1 + 0.1 * torch.randn((L, H), generator=g, device=dev),
                      0.1 * torch.randn((L, H), generator=g, device=dev)], dim=1).repeat(1, 4, 1)
    ln = ln.to(torch.bfloat16).contiguous()
    packs = {
        "int8": {"w": torch.randint(-127, 128, (n, H, H), generator=g, device=dev, dtype=torch.int8),
                 "s": ((0.5 + torch.rand((n, 1, H), generator=g, device=dev)) / (127 * H ** 0.5)
                       ).to(torch.bfloat16), "ln": ln},
        "bf16": {"w": (torch.randn((n, H, H), generator=g, device=dev) / H ** 0.5).to(torch.bfloat16),
                 "s": torch.ones((n, 1, H), dtype=torch.bfloat16, device=dev), "ln": ln},
    }
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
        ms = time_ms(lambda: ds.fused_decode_step(packed, x, ck, cv, offset, k1, v1, cl, n_heads=heads))
        plain_ms = time_ms(lambda: ds.fused_decode_step_plain(packed, x, ck, cv, offset, k2, v2, cl,
                                                              n_heads=heads), iters=3, warmup=1)
        # bytes the step must read: weights, scales, LN, cross K/V, live cache rows
        nbytes = (packed["w"].numel() * packed["w"].element_size() + packed["s"].numel() * 2
                  + ln.numel() * 2 + 2 * ck.numel() * 2 + 2 * L * b * offset * H * 2)
        log(f"[kernels] decode {label}: max|Δ| {err:.3e} (tol {tol:.3e}), new rows {row_err:.3e} "
            f"(tol {row_tol:.3e}), other rows untouched {untouched} | kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e9:.3f} GB) | plain {plain_ms:.4f} ms")
        if not (err <= tol and row_err <= row_tol and untouched):
            failures.append(f"decode {label}: y {err} (tol {tol}), rows {row_err} (tol {row_tol}), "
                            f"untouched {untouched}")
        decode_cases.append(dict(case=label, max_abs_err=err, rel_err=err / tol * DECODE_REL_TOL,
                                 ms=ms, plain_ms=plain_ms, bytes=nbytes))
        del kc, vc, k1, v1, k2, v2
    results["decode_step"] = decode_cases
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("kernels disagree with their plain versions: " + "; ".join(failures))
    return results


def phase_main_musicgen():
    """MusicGen-medium at full width: T5-base and decoder int8 per channel,
    EnCodec f32, as the JAX loader quantizes them; one warm-up and three
    500-step requests with different seeds."""
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
                requests=requests, launches={"lstm": lk.launches, "decode_step": ds.launches})


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


def main() -> int:
    smi, name = phase_device()
    import torch

    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    phase_build()
    kernels = phase_kernels()
    kernels.update(phase_kernels_musicgen())
    main_run = phase_main()
    main_music = phase_main_musicgen()
    small = phase_small()
    small_music = phase_small_musicgen()

    entries = []
    for mod, key, main_case, path in (
            (fa, "flash_attention", "L1280_rope", main_run),
            (im, "int4_matmul", "qkvo_4096x4096_g128", main_run),
            (lk, "lstm", "d1024_T497_bf16", main_music),
            (ds, "decode_step", "int8_B2_W500_off250", main_music)):
        case = next(c for c in kernels[key] if c["case"] == main_case)
        entries.append(dict(name=key, route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
                            launches=path["launches"][key],
                            max_abs_err=max(c["max_abs_err"] for c in kernels[key]),
                            ms=case["ms"], plain_ms=case["plain_ms"]))
    record = dict(device=smi, kernels=kernels, main=main_run, main_musicgen=main_music,
                  small=small, small_musicgen=small_music)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
