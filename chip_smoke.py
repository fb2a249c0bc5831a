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
                      blocks an SM of the wgmma kernels: A's bf16 kernel (at
                      D 128, and at D 64 in both geometries: warpgroups, the
                      setmaxnreg split and rows a block), A's
                      int8 kernel (eight instantiations) and its pre-pass, B's
                      five instantiations (with their ring stages and tiles),
                      E and F, G's GEMM and #13's three kernels (each mode
                      at K 32, 128 and 256), and of D's four
                      instantiations with its ring stages, grid syncs a
                      layer and SASS size; A's bf16 kernel (both head dims),
                      A's int8 kernel and pre-pass, B, E, F, G, #13 and D
                      must not spill nor have their wgmma serialized (C7512,
                      C7515).
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
                      A's persistent bf16 kernel alone at every head-dim-128
                      shape of the Flux paths (L 1280 and 16640 with 24
                      heads, the TP shards' 12 and 6, the ring's folds at L
                      8320 and 4160, training's L 1536, L 1000, B 2 L 1031)
                      against its plain version (out by rel-L2, lse, a
                      dropped-keys control, outputs in freed NaN memory) and
                      in turns with SDPA's forward.
     kernels-sd     — A's bf16 kernel at head dim 64 without RoPE at the
                      UNet self-attention shapes of a 512² SD 2.1 request
                      (CFG, batch 2: L 4096, 1024, 256) and SDXL-Turbo
                      request (batch 1 and 4: L 1024, 256) against its plain
                      version, in turns with SDPA's forward, with each
                      request's sums; and at SD 2.1's first level past 512²
                      (L 6400 at 640², 16384 at 1024²), the plain version a
                      head at a time. Beside each: the geometry the launch
                      picks (d64_geometry: 2 or 3 consumer warpgroups), its
                      tiles and rounds, at three warpgroups the last round's
                      tiles split over keys and their parts (d64_split),
                      checked against the kernel's own merge count
                      (d64_merges), and the exp floor.
  4. kernels-music  — the LSTM (C) and the fused decode step (D) against their
                      plain versions at MusicGen-medium shapes, with times:
                      C at a 500-step and a 2500-step request's length (T 497,
                      2497) and at d 512 in f32, two calls bit for bit, in
                      turns with its route (projection + kernel) and cuDNN's
                      nn.LSTM, with its serial floor (T flagged exchanges)
                      and its per-step phase split; D at int8 B 2 and B 8 in
                      turns with #11 at M 2 and M 8, and B 8's rows 0-1 bit
                      for bit against a B 2 launch.
     kernels-musicgen-f8 — D's e4m3 cache tier against its plain version at
                      MusicGen-medium shapes (B 2 W 2500, B 8 W 2048, bf16
                      weights B 2 W 500), timed in turns with the bf16 tier.
     kernels-chain  — the decode-chain probe (#11, on D's machinery) against
                      its plain version at 48 layers, M 8, 5, 2 and 1, with a
                      control that must miss, its bits over 50 calls and its
                      rows against M-1 calls; timed in turns with D (bf16
                      cache, B 2 W 500 and B 8 W 2048) on the same weights,
                      D − #11 and both phase splits; then the probe's entry
                      point (scripts/prof_decode_chain.run).
     kernels-chain-bisect — the chain-bisect probe (#12) against its plain
                      version at 48 layers, M 8, 5, 2 and 1, for its eight
                      cumulative rungs (no extras, then smem, ln, cross, hbm,
                      bufs, outs, dma added in turn), at M 8 and M 2 each
                      timed in turns with #11 on the same weights; a control
                      that must miss the tolerance; at M 2 and M 8 D − #11
                      and each rung's cost over the one before; then the
                      probe's entry point (scripts/prof_chain_bisect.run: the
                      script's ladder, then every extra, at M 8 and M 2).
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
                      sums; the row quantizer (H) at every activation shape of
                      a "rows" request, queued and by profiler device time,
                      with the request-weighted sums; A's int8 tiers ("qk",
                      "full": the quantize pre-pass, bit for bit, and the
                      int8 wgmma kernel) against their plain versions, the
                      route, pre-pass and kernel in turns with A's bf16 route
                      and SDPA's forward, with bounds and the exp floor.
     kernels-bare-dot — the bare-dot probe #13 in its three modes (bf16, int8,
                      int8 quantized inside) at 64 steps of (1024, 128)·(128,
                      1024), the int8 modes bit for bit, the three in turns
                      with torch.bmm (bf16's yardstick) and a zero fill of
                      out's size, each with its share of its bound.
     kernels-flash-streamed — A through flash_attention_streamed at L 16640
                      (the 2048² sequence): "", "qk" and "full" in groups of
                      1024 keys, held to their plain versions two heads at a
                      time, the bf16 mode in turns with SDPA's forward and
                      its two stages timed alone, the int8 tiers' route,
                      pre-pass and kernel in turns with the bf16 route and
                      SDPA; the streamed "full" at L 1280 in groups of 64 and
                      1024, in turns likewise; then the probe's entry
                      point, scripts/prof_attn_int8.run (8 steps).
     kernels-parallel — A through the model's route at Flux-schnell's
                      tensor-parallel head shards (L 1280, H 12 and 6) against
                      its plain version by rel-L2 with a dropped-keys control,
                      in turns with SDPA's forward; the ring's fold-and-merge
                      (parallel/ring_attention) at 2048² (L 16640) over 2 and
                      4 shards in one process against A over the whole
                      sequence, with a dropped-shard control, each fold and
                      merge timed, a fold in turns with SDPA's forward on the
                      same shard; B on T5-XXL's column and row shards at
                      n = 2 and 4 (M 256, g128, cut by parallel/sharding),
                      in turns with the whole weight's product and with
                      tinygemm on the shard.
  7. main           — Flux-schnell at full width on random weights (flow int8
                      per channel, T5-XXL int4 g=128), three 512², 4-step
                      requests through FluxPipeline.generate_images; checks the
                      images, the latents and the kernels' launch counts; then
                      the conditioning alone under torch.profiler.
  8. main-w8a8      — the same pipeline in the W8A8 configuration: three
                      requests each on the "fused" (G) and "rows" (H) routes,
                      one each with int8 attention "qk" and "full"; checks as
                      main, exact launch counts (A's int8 pre-pass too), and each final latent's
                      rel-L2 against the weight-only latent of its seed;
                      weight-only and "fused" requests in turns; one of each,
                      and a "fused" request with each int8 attention tier,
                      under torch.profiler.
     main-2048      — the same pipeline (weight-only) through the server's
                      generator protocol at 2048²: generate_latents + decode_u8
                      (4 steps, tiled decode), then img2img on that image
                      (generate_latents_from_image, strength 0.5, tiled
                      encode): phase split, peak memory, exact launch counts,
                      the request under torch.profiler; at 512²
                      generate_images_fused equal to generate_images byte for
                      byte, with no host synchronisation inside it.
     main-parallel  — the parallel entry points at world 1 under an NCCL
                      group of one process, on the same pipeline: a 512²
                      request after shard() and one after
                      enable_pipeline_parallel(), each equal byte for byte to
                      main's at its seed with 228 A and 168 B launches; a
                      2048² request with enable_ring_attention(threshold=
                      16384) against main-2048's latent (rel-L2, and byte
                      for byte: a ring of one fold is exact); a small-depth
                      Flux-dev dreambooth.train step under the group equal to
                      the step before it; main's prompts through the native
                      and Python tokenizer engines (ids equal, host µs a
                      prompt). The group is destroyed at the end.
  9. main-musicgen  — MusicGen-medium at full width on random weights (decoder
                      and T5-base int8 per channel, EnCodec f32), three
                      500-step requests through MusicGenPipeline.generate;
                      checks the waveforms, the codes and the launch counts.
     main-musicgen-serve — the same pipeline serving four users at once
                      through generate_requests (250/500/1000/1500 steps,
                      seeds 1-4), on bf16 and on e4m3 caches; then at top_k 1
                      each request's codes coalesced against its solo run.
     main-musicgen-long — one 2500-step request on bf16, then on e4m3
                      caches, with the device ms a step at its start and end
                      and C's 2 launches.
 10. main-train     — DreamBooth LoRA training of Flux-dev at full width on
                      random weights through training.dreambooth.train: 3
                      optimizer steps of 4 micro-steps on two seeded images;
                      checks losses, the adapters and the launch counts (A,
                      its RoPE pre-pass, E, F and B); then one optimizer step
                      under each --remat-policy in turns (block, dots, dots,
                      block) from the trained LoRA on the same batches:
                      losses equal, step time, peak memory, E and F launches.
     main-sd        — SD 2.1-base and SDXL-Turbo at full width on random
                      weights (bf16), 512², through generate_latents_batch
                      + decode_u8: SD 2.1 at 50 steps, cfg 4.0, three
                      requests; SDXL-Turbo at 2 steps without CFG, batch 1
                      (two requests) and 4, and an img2img at strength 0.5
                      (generate_latents_from_image, 1 step); phase split,
                      peak memory, exact A launch counts (750 an SD 2.1
                      request, 140 an SDXL one, 70 the img2img), then one
                      request of each under torch.profiler (busy share; SD
                      2.1's at SD21_PROFILE_STEPS steps).
     main-serve     — the port's server (server/app.get_app, server/httpd.
                      Server on 127.0.0.1) with full-width bf16 pipelines on
                      random weights, the plan its memory planner makes on
                      this card, driven over HTTP: Flux-schnell 512² (alone,
                      then 4 at once), SD 2.1-base (50 steps, cfg 4.0, with
                      /sdapi/v1/progress polled), SDXL-Turbo (alone, 4 at
                      once, img2img at 0.5), MusicGen 500 steps (alone, 4 at
                      once); each solo answer equal byte for byte to the same
                      pipeline's direct call with the same A, C and D
                      launches, each group coalesced, 422 and 429 where due;
                      the server's overhead, resident and peak memory beside
                      the planner's estimates.
     main-serve-int8 — a second API with quantize=True and the "fused"
                      W8A8 route, its pipelines quantized as the loaders do:
                      one Flux, one SD 2.1 and one music request, each with
                      G or H launched.
     main-cli       — the five CLIs (flux_generator_tpu_torch/cli) from
                      synthetic caches at full published width, written in
                      bf16 (t5-base and EnCodec in f32) by io/synthetic in
                      the hub layout into a temporary HF_HUB_CACHE, one
                      family at a time and deleted before the next: each
                      family's write and its from_pretrained load timed
                      with the host's peak RSS; each CLI's run(pipeline,
                      args) against the same pipeline's direct call, the
                      PNG or WAV equal byte for byte, with exact A, RoPE
                      pre-pass, C and D launches (txt2image 2 images: 228
                      and 228; sd_txt2image SD 2.1: 750, SDXL-Turbo batch
                      4: 140, and with --quantize, int8 UNet and CLIPs:
                      140; image2image on the SD 2.1 PNG: 70;
                      musicgen_generate: C 2, D 500); the music CLI once
                      more as a real `python -m` subprocess (50 steps: exit
                      0, a WAV, no jax module imported); t5_generate's 64
                      greedy tokens on the card equal to a CPU f32 run's.
     main-codec     — EnCodec's encoder at full width on the card on that
                      500-step WAV read back with `wave`: C's 2 launches, the
                      embedding against the CPU's f32 plain path (rel-L2),
                      the share of codes equal to the CPU's with a control
                      that must miss (another seed's weights), decode of
                      the codes, encode's time and C's share of it.
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
 15. small-sd       — small SD and SDXL configs (heads of 64, a 256-token
                      self-attention) on the card (bf16, kernel A) against
                      the CPU (f32, its plain version), same weights, tokens
                      and noise.
     small-serve    — a small SD config with int8 UNet and CLIP denses,
                      w8a8 "fused" and attn_int8 "qk", on the card (A's
                      int8 tier, G) against the CPU (their plain versions).
Before the last lines: the kernels' JSON line ({"kernels": [...]}), each
phase's wall seconds ({"phase_seconds": {...}}) and the card's name and
power limit. The last line printed is {"ok": true, "device": {...}}; a
fuller record goes to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --profile-train

instead profiles one optimizer step (4 micro-steps) of the main-train
configuration through the trainer's step function under torch.profiler
(device time by kernel group, busy share, per micro-step) into
chiprun_out/profile_train.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# A's bf16 tier at the SD shapes (head dim 64, no RoPE) against its plain
# version: (out rel-L2, lse max|Δ|). With unit-normal q, k and v the output
# is an average over many keys, so its entries are small (about 0.02 at L
# 4096) and a max-abs bound on it would pass an output 10% wrong; rel-L2
# scales with the output. bf16 P and O rounding come to a few 1e-3 of it. A
# control must fail it: the plain function with the last 64 keys dropped,
# which moves out by about sqrt(64/L) of itself (0.125 at L 4096) but lse by
# about log(L/(L-64)) (1.6e-2 on an average row at L 4096, within lse's
# bound).
SD_FLASH_TOL = (1e-2, FLASH_TOL)
# flash backward, of max|ref|: P and dS rounded to bf16 before their products,
# bf16 outputs, against the f32 plain backward
FLASH_BWD_REL_TOL = 2e-2
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 and int8 tensor
# cores, HBM
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES_S = 989e12, 1979e12, 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
# exponentials a second on the special-function units (H100 SXM, as
# FlashAttention-3 reports it): the softmax's floor beside an attention bound
PEAK_EXP_S = 3.9e12
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

# SD 2.1-base and SDXL-Turbo at 512²: the server's defaults for SD 2.1 (50
# steps, server/api.py:284; cfg 4.0, server/schemas.py:16), the Turbo's 2
# steps without CFG, and a coalesce bucket of 4 (server/api.py:165)
SD21_STEPS, SD21_CFG, SDXL_STEPS = 50, 4.0, 2
# steps of the SD 2.1 request under torch.profiler (its 50 steps' 135,578
# launches took the profiler ~90 s to gather); its busy share and device
# time by kernel group cover these steps
SD21_PROFILE_STEPS = 10
SD_PROMPTS = [
    (21, "a watercolor of a fox in a misty pine forest"),
    (22, "a studio photograph of a glazed ceramic teapot"),
    (23, "an aerial view of terraced rice fields at dawn"),
    (24, "a pencil sketch of an old lighthouse"),
]
# kernel A's self-attention shapes in those requests (label, B, L, heads of
# 64, calls a request): SD 2.1 under CFG at its 64², 32² and 16² levels (5
# calls a UNet call each, 50 calls); SDXL at 32² (10 a call) and 16² (60),
# 2 calls, at batch 1 and 4
SD_ATTN_SHAPES = (("sd21_L4096", 2, 4096, 5, 250), ("sd21_L1024", 2, 1024, 10, 250), ("sd21_L256", 2, 256, 20, 250),
                  ("sdxl_b1_L1024", 1, 1024, 10, 20), ("sdxl_b1_L256", 1, 256, 20, 120),
                  ("sdxl_b4_L1024", 4, 1024, 10, 20), ("sdxl_b4_L256", 4, 256, 20, 120))
# kernel A at SD 2.1's first UNet level past 512², which the server admits up
# to 2048² (server/api.py MAX_SIDE): (label, B, L, heads of 64, calls a
# 50-step request at that level): 640² (an 80² latent) and 1024² (128²)
SD_ATTN_LONG_SHAPES = (("sd21_640_L6400", 2, 6400, 5, 250), ("sd21_1024_L16384", 2, 16384, 5, 250))


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
    info = {f"D {d}" + (f", {w} consumer warpgroups" if d == 64 else ""): fa.sm90_kernel_info(d, w)
            for d in fa.HEAD_DIMS for w in (fa.WARPGROUPS_D64 if d == 64 else (2,))}
    for key, rec in info.items():
        log(f"[build] flash_attention_sm90 {key}: {rec['warpgroups']} warpgroups (a producer and "
            f"{rec['warpgroups'] - 1} consumers), {rec['row_block']} query rows a block, {rec['registers']} "
            f"registers a thread at launch (setmaxnreg: {rec['setmaxnreg'][0]} producer, {rec['setmaxnreg'][1]} "
            f"consumers), {rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of shared memory a "
            f"block, {rec['blocks_per_sm']} block(s) an SM")
    int8_info = {f"D {d}, {mode}, {tile}-key tiles": fa.int8_kernel_info(d, mode, tile) for d in fa.HEAD_DIMS
                 for mode, tile in (("qk", 128), ("full", 128), ("full_streamed", 128), ("full_streamed", 64))}
    for key, rec in int8_info.items():
        log(f"[build] flash_attention A int8, {key}: {rec['registers']} registers a thread at launch (setmaxnreg: "
            f"40 producer, 232 consumers), {rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of "
            f"shared memory a block, {rec['blocks_per_sm']} block(s) an SM")
    pre_info = {f"D {d}, {which}": rec for d in fa.HEAD_DIMS for which, rec in fa.int8_prepass_info(d).items()}
    for key, rec in pre_info.items():
        log(f"[build] flash_attention A int8 pre-pass, {key} launch: {rec['registers']} registers a thread, "
            f"{rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of shared memory a block, "
            f"{rec['blocks_per_sm']} block(s) an SM")
    bwd_info = {d: fb.kernel_info(d) for d in fb.HEAD_DIMS}
    for d, recs in bwd_info.items():
        for which, rec in recs.items():
            log(f"[build] flash_attention_bwd {'E' if which == 'dq' else 'F'} ({which}) D {d}: "
                f"{rec['registers']} registers a thread at launch (setmaxnreg: 40 producer, 232 consumers), "
                f"{rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of shared memory a "
                f"block, {rec['blocks_per_sm']} block(s) an SM")
    g_info = {f"{bk}x{bn}": wm.kernel_info(bk, bn) for bk in wm.BK_CANDIDATES for bn in wm.TILE_WIDTHS}
    for key, rec in g_info.items():
        log(f"[build] w8a8_matmul G GEMM, K block x tile width {key}: {rec['registers']} registers a thread at "
            f"launch (setmaxnreg: 40 producer, 232 consumers), {rec['spill_bytes']} bytes of local memory, "
            f"{rec['smem_bytes']} bytes of shared memory a block, {rec['blocks_per_sm']} block(s) an SM")
    # #13 in each mode (the int8 modes one instantiation a K / 32)
    dot_info = {f"{mode}, K {k}": bd.kernel_info(mode, k) for mode in bd.MODES
                for k in (bd.K_RANGE[0], 128, bd.K_RANGE[1])}
    nreg = {"bf16": "40 producer, 232 consumers", "int8": "40 producer, 232 consumers",
            "int8_quant_inside": "96 quantizer, 200 consumers"}
    for key, rec in dot_info.items():
        log(f"[build] bare_dot {key}: {rec['registers']} registers a thread at launch (setmaxnreg: "
            f"{nreg[key.split(',')[0]]}), {rec['spill_bytes']} bytes of local memory, {rec['smem_bytes']} bytes of "
            f"shared memory a block, {rec['blocks_per_sm']} block(s) an SM, a ring of {rec['stages']} stages")
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
    chain_info = dc.kernel_info()
    log(f"[build] decode_chain #11 (and #12, the same kernel with its extras): {chain_info['registers']} registers "
        f"a thread, {chain_info['local_bytes']} bytes of local memory (its calls' stack), {chain_info['smem_bytes']} "
        f"bytes of shared memory a block, {chain_info['blocks_per_sm']} block(s) an SM, a weight ring of "
        f"{chain_info['ring_stages']} stages, {chain_info['syncs_per_layer']} grid syncs a layer")
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
    # A's bf16 and int8 kernels, B, E, F, G's GEMM and #13's three kernels keep their products
    # asynchronous and in registers; none of them, nor A's int8 pre-pass or D, spills
    serialized = [line.strip() for name in ("flash_attention_sm90", "flash_attention", "int4_matmul",
                                            "flash_attention_bwd", "w8a8_matmul", "bare_dot", "decode_step")
                  for line in _build.BUILD_INFO[name][1].splitlines() if "C7512" in line or "C7515" in line]
    spills = {(d, w): r["spill_bytes"] for d, recs in bwd_info.items() for w, r in recs.items() if r["spill_bytes"]}
    spills.update({("A bf16", d): r["spill_bytes"] for d, r in info.items() if r["spill_bytes"]})
    spills.update({("G", key): r["spill_bytes"] for key, r in g_info.items() if r["spill_bytes"]})
    spills.update({("B", key): r["spill_bytes"] for key, r in b_info.items() if r["spill_bytes"]})
    spills.update({("bare_dot", k): r["spill_bytes"] for k, r in dot_info.items() if r["spill_bytes"]})
    spills.update({("A int8", k): r["spill_bytes"] for k, r in int8_info.items() if r["spill_bytes"]})
    spills.update({("A int8 pre-pass", k): r["spill_bytes"] for k, r in pre_info.items() if r["spill_bytes"]})
    # D's phases are calls with a stack: its spills are ptxas's, for the kernels and every function;
    # C holds Wh in registers and H a row's chunks: their spills are ptxas's too
    for label, name in (("D", "decode_step"), ("C", "lstm"), ("G and H", "w8a8_matmul"),
                        ("A bf16", "flash_attention_sm90"), ("#11", "decode_chain"), ("#12", "chain_bisect")):
        found = [int(n) for pair in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                               _build.BUILD_INFO[name][1]) for n in pair]
        if any(found):
            spills[(label, "ptxas")] = max(found)
    if serialized or spills:
        raise AssertionError(f"tensor-core kernels: serialized {serialized}, spills {spills}")
    return {"flash_attention_sm90": info, "flash_attention_int8": int8_info, "flash_attention_int8_prepass": pre_info,
            "flash_attention_bwd": bwd_info, "w8a8_matmul": g_info, "int4_matmul": b_info,
            "bare_dot": dot_info, "decode_step": d_info, "decode_step_sass_instructions": d_code,
            "decode_chain": chain_info}


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
    results["flash_attention_d128"] = _phase_kernels_flash_d128(g)

    results.update(_phase_kernels_int4(g))
    torch.cuda.synchronize()
    return results


# (label, B, L, H) of A's head-dim-128 kernel (persistent, flash_attention_sm90)
# without RoPE: Flux's 512² and 2048² joint sequences, the tensor-parallel
# head shards, the ring's folds of 2048² over 2 and 4 ranks, Flux-dev
# training's L 1536, L 1000, and a ragged length at B 2 (several tiles a CTA)
FLASH_D128_SHAPES = (("L1280_H24", 1, 1280, 24), ("L16640_H24", 1, 16640, 24), ("L1280_H12_tp2", 1, 1280, 12),
                     ("L1280_H6_tp4", 1, 1280, 6), ("L8320_H24_ring2", 1, 8320, 24),
                     ("L4160_H24_ring4", 1, 4160, 24), ("L1536_H24_dev", 1, 1536, 24),
                     ("L1000_H24", 1, 1000, 24), ("B2_L1031_H24", 2, 1031, 24))


def _phase_kernels_flash_d128(g) -> list:
    """A's persistent kernel at every FLASH_D128_SHAPES row: out by rel-L2
    and lse by max-abs against the plain version in f32 on the same bf16
    inputs (a head at a time past L 4096), a dropped-keys control that must
    fail, no NaN left in outputs that took the memory of NaN tensors freed
    just before the call, and the kernel in turns with SDPA's forward."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import _build
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    tol_out, tol_lse = SD_FLASH_TOL
    sms = _build.sm_count(dev.index or 0)
    plain = (lambda q_, k_, v_, cos_, sin_: fa.flash_attention_reference(q_.float(), k_.float(), v_.float()))
    rows = []
    for label, b, length, h in FLASH_D128_SHAPES:
        q, k, v = (torch.randn((b, length, h, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        nan_out = torch.full_like(q, float("nan"))
        nan_lse = torch.full((b * h, length), float("nan"), device=dev)
        del nan_out, nan_lse
        out, lse = fa.flash_attention_sm90(q, k, v)
        torch.cuda.synchronize()
        nans = int(out.isnan().sum().item() + lse.isnan().sum().item())
        chunk = 24 if length <= 4096 else 1
        ref, ref_lse = _plain_by_heads(plain, q, k, v, None, None, chunk)
        rel, lse_err = _rel(out.float(), ref), (lse - ref_lse).abs().max().item()
        dropped, _ = _plain_by_heads(plain, q, k[:, :-64], v[:, :-64], None, None, chunk)
        control = _rel(dropped, ref)
        del ref, ref_lse, dropped
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        iters = 20 if length <= 4096 else 5
        turns = in_turns({"A": lambda: fa.flash_attention_sm90(q, k, v),
                          "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)}, iters)
        ms, library_ms = statistics.mean(turns["A"]), statistics.mean(turns["sdpa"])
        tiles = b * h * -(-length // 128)
        plan = dict(row_blocks=-(-length // 128), tiles=tiles, ctas=min(tiles, sms))  # the kernel's launch
        bound = bound_ms(4 * b * h * length * length * 128, 4 * q.numel() * 2 + b * h * length * 4)
        rows.append(dict(case=label, b=b, l=length, h=h, out_rel_l2=rel, lse_max_abs_err=lse_err,
                         control_last_64_keys_dropped_out_rel_l2=control, nan_left=nans, ms=ms,
                         library_ms=library_ms, turns_ms=turns, bound_ms=bound[0], bound_by=bound[1],
                         bound_share=bound[0] / ms, **plan, rounds=plan["tiles"] / sms))
        log(f"[kernels] A persistent {label} (B {b}, L {length}, H {h}, D 128): out rel-L2 {rel:.3e} (tol {tol_out}), "
            f"lse max|Δ| {lse_err:.3e} (tol {tol_lse}), NaN left {nans} (must be 0) | control, last 64 keys "
            f"dropped: {control:.3e} (must exceed {tol_out}) | {plan['tiles']} tiles on {plan['ctas']} CTAs "
            f"({plan['tiles'] / sms:.2f} rounds) | in turns: A {' '.join(f'{t:.4f}' for t in turns['A'])}, SDPA "
            f"fwd {' '.join(f'{t:.4f}' for t in turns['sdpa'])} ms ({ms / library_ms:.3f}x) | "
            f"{100 * bound[0] / ms:.1f}% of the bound {bound[0]:.4f} ms ({bound[1]})")
        if not (rel <= tol_out and lse_err <= tol_lse and nans == 0):
            raise AssertionError(f"A persistent {label} disagrees with its plain version: rel-L2 {rel}, lse "
                                 f"{lse_err}, NaN left {nans}")
        if not control > tol_out:
            raise AssertionError(f"A persistent {label}: the dropped-keys control passes ({control})")
        del q, k, v, qs, ks, vs, out, lse
        torch.cuda.empty_cache()
    return rows


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
    modes bit for bit, bf16 within one bf16 step of max|out|. The three
    modes, torch.bmm on the bf16 blocks (the yardstick for "bf16") and a zero
    fill of out's size (what its 134 MB alone take to write) are timed in
    turns (CUDA events behind a sleep kernel); no PyTorch call computes the
    int8 modes (torch._int_mm has no batched form, and none quantizes
    inside). Each mode's share of its bound (bytes: a and b read once, out
    written once) is printed, and the int8 modes' launch plans (blocks,
    blocks a cluster)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import bare_dot as bd
    from flux_generator_tpu_torch.scripts.prof_attn_int8 import BM, BN, K, dot_inputs

    dev = torch.device("cuda")
    steps = 64
    inputs = {mode: dot_inputs(mode, steps, dev, seed=13) for mode in bd.MODES}
    checks = {}
    for mode, (a, b) in inputs.items():
        ref = bd.bare_dot_reference(a, b, mode)
        err = (bd.bare_dot(a, b, mode).float() - ref.float()).abs().max().item()
        tol = 0.0 if mode != "bf16" else 2.0 ** -8 * ref.float().abs().max().item()
        plain_ms = time_ms(lambda: bd.bare_dot_reference(a, b, mode), iters=5, warmup=1)
        checks[mode] = (err, tol, plain_ms)
        del ref
    a3 = inputs["bf16"][0].view(steps, BM, K)
    b3 = inputs["bf16"][1].view(K, steps, BN).permute(1, 0, 2)
    lib_err = (torch.bmm(a3, b3).reshape(steps * BM, BN).float()
               - bd.bare_dot_reference(*inputs["bf16"], "bf16").float()).abs().max().item()
    out = torch.empty((steps * BM, BN), dtype=torch.bfloat16, device=dev)
    fns = {mode: (lambda m=mode: bd.bare_dot(*inputs[m], m)) for mode in bd.MODES}
    turns = in_turns({**fns, "bmm": lambda: torch.bmm(a3, b3), "zero": lambda: out.zero_()})
    log("[kernels-bare-dot] in turns: " + " | ".join(f"{name} " + " ".join(f"{t:.4f}" for t in ts) + " ms"
                                                     for name, ts in turns.items())
        + f" | torch.bmm max|Δ| {lib_err:.3e}")
    cases = {}
    failures = []
    for mode, (a, b) in inputs.items():
        err, tol, plain_ms = checks[mode]
        ms = statistics.mean(turns[mode])
        flop = 2 * BM * K * BN * steps
        nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() + 2 * steps * BM * BN
        bound = bound_ms(flop, nbytes, PEAK_INT8_OPS if mode != "bf16" else PEAK_BF16_FLOPS)
        plan = bd.plan(mode, K, BM, BN, steps) if mode != "bf16" else None
        library_ms = statistics.mean(turns["bmm"]) if mode == "bf16" else None
        log(f"[kernels-bare-dot] {mode} steps={steps}: max|Δ| {err:.3e} (tol {tol:.3e}) | kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.1f} TOP/s-eff, {nbytes / ms / 1e6:.1f} GB/s, {100 * bound[0] / ms:.1f}% of its bound "
            f"{bound[0]:.4f} ms ({bound[1]}); {ms / statistics.mean(turns['bf16']):.3f}× bf16, "
            f"{ms / statistics.mean(turns['zero']):.3f}× the zero fill) | plain {plain_ms:.4f} ms"
            + (f" | launch {plan['grid']} blocks, clusters of {plan['cluster']}" if plan else "")
            + (f" | torch.bmm {library_ms:.4f} ms" if library_ms else " | library none"))
        if not err <= tol:
            failures.append(f"{mode}: {err} > {tol}")
        cases[mode] = dict(case=f"{mode}_steps{steps}", max_abs_err=err, ms=ms, ms_in_turns=turns[mode],
                           plain_ms=plain_ms, library_ms=library_ms,
                           library_ms_in_turns=turns["bmm"] if mode == "bf16" else None,
                           zero_fill_ms_in_turns=turns["zero"], bound_ms=bound[0], bound_by=bound[1],
                           bound_share=bound[0] / ms, plan=plan)
    if failures:
        raise AssertionError("bare dot disagrees with its plain version: " + "; ".join(failures))
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
    time), the int8 tiers' route (pre-pass + kernel), pre-pass and kernel in
    turns with A's bf16 route and SDPA's forward, queued; the streamed "full"
    also at L 1280 in groups of 64 and 1024, timed alike; the one-shot "full"
    as the control it must tell apart. Then the probe's entry point, prof_attn_int8.run
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
        if tier:  # the route, its pre-pass and kernel apart, A's bf16 route and SDPA's forward in turns
            mode, group = ("qk", 0) if tier == "qk" else ("full_streamed", 1024)
            pre = fa.int8_prepass(q, k, v, cos, sin, mode, group)
            int8_turns = in_turns(
                {"route": lambda: fa.flash_attention_streamed(q, k, v, cos, sin, int8=tier, blk_k=1024),
                 "prepass": lambda: fa.int8_prepass(q, k, v, cos, sin, mode, group),
                 "kernel": lambda: fa.int8_attention(pre, v, d ** -0.5, mode, group),
                 "bf16_route": lambda: fa.flash_attention_streamed(q, k, v, cos, sin, blk_k=1024),
                 "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)}, iters=3)
            del pre
            ms = statistics.mean(int8_turns["route"])
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
        if tier:
            exp_ms = l * l * h / PEAK_EXP_S * 1e3
            rec.update(turns_ms=int8_turns, route_ms=ms, ms=statistics.mean(int8_turns["kernel"]),
                       prepass_ms=statistics.mean(int8_turns["prepass"]),
                       bf16_route_ms=statistics.mean(int8_turns["bf16_route"]), bound_share=bound[0] / ms,
                       exp_floor_ms=exp_ms)
            log(f"[kernels-flash-streamed] {name} L={l}: in turns: route "
                + " ".join(f"{t:.4f}" for t in int8_turns["route"]) + " ms, pre-pass "
                + " ".join(f"{t:.4f}" for t in int8_turns["prepass"]) + " ms, kernel "
                + " ".join(f"{t:.4f}" for t in int8_turns["kernel"]) + " ms, bf16 route "
                + " ".join(f"{t:.4f}" for t in int8_turns["bf16_route"]) + " ms, SDPA bf16 forward "
                + " ".join(f"{t:.4f}" for t in int8_turns["sdpa"])
                + f" ms | route {ms / rec['bf16_route_ms']:.2f}x the bf16 route, {100 * bound[0] / ms:.1f}% of "
                f"the bound, exp floor {exp_ms:.4f} ms")
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
        log(f"[kernels-flash-streamed] {name} L={l} H={h}: {note} | route {ms:.4f} ms "
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
        pre = fa.int8_prepass(q, k, v, cos, sin, "full_streamed", blk)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (*fa.rope_rotate(q, k, cos, sin), v))
        turns = in_turns({"route": lambda: fa.flash_attention_streamed(q, k, v, cos, sin, int8="full", blk_k=blk),
                          "prepass": lambda: fa.int8_prepass(q, k, v, cos, sin, "full_streamed", blk),
                          "kernel": lambda: fa.int8_attention(pre, v, 128 ** -0.5, "full_streamed", blk),
                          "bf16_route": lambda: fa.flash_attention_streamed(q, k, v, cos, sin, blk_k=blk),
                          "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
        ms = statistics.mean(turns["route"])
        bound = bound_ms_parts([(4 * length * length * 128 * 24, PEAK_INT8_OPS)],
                               4 * q.numel() * 2 + 2 * cos.numel() * 2 + length * 24 * 4)
        exp_ms = length * length * 24 / PEAK_EXP_S * 1e3
        tol_out, tol_lse = INT8_ATTN_TOL["full"]
        log(f"[kernels-flash-streamed] full_streamed L={length} blk_k={blk}: out rel-L2 {rel:.3e} "
            f"(tol {tol_out}), lse max|Δ| {err_lse:.3e} | one-shot control {ctrl_rel:.3e} | in turns: route "
            + " ".join(f"{t:.4f}" for t in turns["route"]) + " ms, pre-pass "
            + " ".join(f"{t:.4f}" for t in turns["prepass"]) + " ms, kernel "
            + " ".join(f"{t:.4f}" for t in turns["kernel"]) + " ms, bf16 route "
            + " ".join(f"{t:.4f}" for t in turns["bf16_route"]) + " ms, SDPA bf16 forward "
            + " ".join(f"{t:.4f}" for t in turns["sdpa"])
            + f" ms | bound {bound[0]:.4f} ms ({bound[1]}; {100 * bound[0] / ms:.1f}%), exp floor {exp_ms:.4f} ms")
        del pre, qs, ks, vs
        if not (rel <= tol_out and err_lse <= tol_lse):
            failures.append(f"full_streamed L {length} blk {blk}: rel {rel}, lse {err_lse}")
        if not ctrl_rel > tol_out:
            failures.append(f"full_streamed L {length} blk {blk}: the one-shot control passes ({ctrl_rel})")
        short.append(dict(case=f"L{length}_blk{blk}", out_rel_l2=rel, lse_max_abs_err=err_lse,
                          control_one_shot_out_rel_l2=ctrl_rel, ms=ms, turns_ms=turns, bound_ms=bound[0],
                          exp_floor_ms=exp_ms))
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
            "flash_attention_int8_full": fa.int8_launches["full"],
            "flash_attention_int8_quant": fa.int8_quant_launches, "int4_matmul": im.launches,
            "w8a8_matmul": wm.launches, "w8a8_quantize_rows": wm.quantize_launches}


def _reset_launch_counts():
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm

    fa.launches = im.launches = wm.launches = wm.quantize_launches = fa.rope_launches = 0
    fa.int8_quant_launches = 0
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
    take the "ops" formulation; the int8 tiers' pre-pass once an attention
    call for "qk" and twice for "full"), and the final latent's rel-L2 against the
    weight-only latent of its seed. Then weight-only and "fused" requests in
    turns for their latencies on one card, and one of each, and one "fused"
    request with each int8 attention tier, under torch.profiler."""
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
                    # the int8 tiers' pre-pass: q/k, and for "full" V too
                    "flash_attention_int8_quant": attn * {"": 0, "qk": 1, "full": 2}[attn_int8],
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
                f"{n['flash_attention_int8_qk']}, full {n['flash_attention_int8_full']}; pre-pass "
                f"{n['flash_attention_int8_quant']}) B "
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
    for label, w8a8, attn_int8 in (("weight_only", None, ""), ("fused", "fused", ""), ("fused+qk", "fused", "qk"),
                                   ("fused+full", "fused", "full")):
        pipe.w8a8, pipe.attn_int8 = w8a8, attn_int8
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
    latent_2048 = x_t

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
                launches={"flash_attention": blocks * STEPS, "int4_matmul": 24 * 7}), latent_2048



# ------------------------------------------------------------ the parallel layer (world 1 on one card)

# Flux-schnell's attention at 512² on 2 and 4 tensor-parallel ranks: each rank
# runs 24/n heads of the 1280-token joint sequence
TP_HEAD_SHARDS = ((2, 12), (4, 6))
RING_LENGTH = 16640  # a 2048² request's joint sequence: 16384 image + 256 text tokens
RING_SHARDS = (2, 4)
# the ring's merged output against A over the whole sequence, rel-L2: each
# fold rounds its output to bf16 before the f32 merge (A's own bf16 output
# rounding, 2^-9 relative, a fold); dropping one of n shards moves it by
# O(1/n) of itself
RING_REL_TOL = 1e-2


def phase_kernels_parallel():
    """The kernels on the parallel paths' shapes, at full width. A through
    the model's route (RoPE pre-pass, then the kernel) at Flux-schnell's
    tensor-parallel head shards (L 1280, H 12 and 6), held to its plain
    version by rel-L2 with a dropped-keys control, in turns with SDPA's
    forward; the ring's fold-and-merge (parallel/ring_attention.
    fold_and_merge) at 2048² (L 16640) over 2 and 4 shards in one process,
    every rank's folds against A over the whole sequence, with a
    dropped-shard control, each fold and merge timed, a fold in turns with
    SDPA's forward on the same shard; B on T5-XXL's col and row shards at n
    = 2 and 4 (rank 0's shard cut by parallel/sharding from the whole
    quantized weight), held to its plain version, timed in turns with the
    whole weight's product and with tinygemm on the shard."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.ops.quant import quantize_dense
    from flux_generator_tpu_torch.parallel.ring_attention import fold_and_merge, merge_fold
    from flux_generator_tpu_torch.parallel.sharding import shard_dense

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2718)
    t_phase = time.perf_counter()
    rows, ring_rows, b_rows = [], [], []

    # A at the head shards: the model's route (flash_attention with tables)
    cos, sin = _flux_rope_tables(1280)
    tol_out, tol_lse = SD_FLASH_TOL
    for n, heads in TP_HEAD_SHARDS:
        q, k, v = (torch.randn((1, 1280, heads, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        out, lse = fa.flash_attention(q, k, v, cos, sin, return_lse=True)
        # the plain function in f32: RoPE, then attention; the control drops
        # the last 64 rotated keys
        qf, kf = fa.rope_rotate_reference(q.float(), k.float(), cos.float(), sin.float())
        ref, ref_lse = fa.flash_attention_reference(qf, kf, v.float())
        rel, lse_err = _rel(out.float(), ref), (lse - ref_lse).abs().max().item()
        dropped, _ = fa.flash_attention_reference(qf, kf[:, :-64], v[:, :-64].float())
        control = _rel(dropped, ref)
        qr, kr = fa.rope_rotate(q, k, cos, sin)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qr, kr, v))
        turns = in_turns({"route": lambda: fa.flash_attention(q, k, v, cos, sin),
                          "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
        ms = time_ms_queued(lambda: fa.flash_attention_sm90(qr, kr, v))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(qr, kr, v), iters=5)
        flops = 4 * 1280 * 1280 * 128 * heads
        bound = bound_ms(flops, 4 * q.numel() * 2 + 1280 * heads * 4)
        row = dict(case=f"L1280_H{heads}_tp{n}", n=n, heads=heads, max_abs_err=(out.float() - ref).abs().max().item(),
                   out_rel_l2=rel, lse_max_abs_err=lse_err, control_last_64_keys_dropped_out_rel_l2=control,
                   ms=ms, route_ms=statistics.mean(turns["route"]), plain_ms=plain_ms,
                   library_ms=statistics.mean(turns["sdpa"]), turns_ms=turns, bound_ms=bound[0], bound_by=bound[1],
                   bound_share=bound[0] / ms)
        log(f"[kernels-parallel] A route at the TP{n} head shard (L 1280, H {heads}, D 128, RoPE): out rel-L2 "
            f"{rel:.3e} (tol {tol_out}), lse max|Δ| {lse_err:.3e} (tol {tol_lse}) | control, last 64 keys dropped: "
            f"{control:.3e} (must exceed {tol_out}) | kernel {ms:.4f} ms ({100 * bound[0] / ms:.1f}% of the bound "
            f"{bound[0]:.4f} ms, {bound[1]}) | in turns: route {' '.join(f'{t:.4f}' for t in turns['route'])}, SDPA "
            f"fwd {' '.join(f'{t:.4f}' for t in turns['sdpa'])} ms | plain {plain_ms:.4f} ms")
        if not (rel <= tol_out and lse_err <= tol_lse):
            raise AssertionError(f"A at H {heads} disagrees with its plain version: rel-L2 {rel}, lse {lse_err}")
        if not control > tol_out:
            raise AssertionError(f"A at H {heads}: the dropped-keys control passes ({control})")
        rows.append(row)
        del q, k, v, qs, ks, vs, qr, kr, ref, dropped, qf, kf

    # the ring's folds at 2048²: RoPE once over the whole sequence, then every
    # rank's L/n queries against each K/V shard, merged in f32
    # (q and k stand for the rotated ones: the ring rotates the whole
    # sequence before it splits it)
    q, k, v = (torch.randn((1, RING_LENGTH, 24, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    whole, _ = fa.flash_attention_sm90(q, k, v)
    whole_ms = time_ms_queued(lambda: fa.flash_attention_sm90(q, k, v), iters=10)
    for n in RING_SHARDS:
        c = RING_LENGTH // n
        ks, vs = k.split(c, 1), v.split(c, 1)
        shards = list(zip(ks, vs))
        outs = [fold_and_merge(q[:, i * c:(i + 1) * c].contiguous(), shards) for i in range(n)]
        merged = torch.cat(outs, 1)
        rel = _rel(merged.float(), whole.float())
        control = _rel(torch.cat([fold_and_merge(q[:, i * c:(i + 1) * c].contiguous(), shards[:-1])
                                  for i in range(n)], 1).float(), whole.float())
        q0 = q[:, :c].contiguous()
        fold = fa.flash_attention_sm90(q0, ks[0].contiguous(), vs[0].contiguous())
        k0, v0 = ks[0].contiguous(), vs[0].contiguous()
        fold_ms = time_ms_queued(lambda: fa.flash_attention_sm90(q0, k0, v0), iters=10)
        q0s, k0s, v0s = (x.transpose(1, 2).contiguous() for x in (q0, k0, v0))
        fold_turns = in_turns({"fold": lambda: fa.flash_attention_sm90(q0, k0, v0),
                               "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q0s, k0s, v0s)},
                              iters=10)
        state = merge_fold(None, *fold)
        merge_ms = time_ms_queued(lambda: merge_fold(state, *fold), iters=10)
        rank_ms = time_ms_queued(lambda: fold_and_merge(q0, shards), iters=5)
        flops = 4 * c * c * 128 * 24
        bound = bound_ms(flops, 4 * q0.numel() * 2 + c * 24 * 4)
        row = dict(case=f"L{RING_LENGTH}_ring{n}", n=n, shard_length=c, out_rel_l2=rel,
                   control_last_shard_dropped_out_rel_l2=control, fold_ms=fold_ms, merge_ms=merge_ms,
                   rank_ms=rank_ms, whole_ms=whole_ms, overhead=rank_ms / (whole_ms / n),
                   fold_bound_ms=bound[0], fold_bound_by=bound[1], fold_turns_ms=fold_turns,
                   fold_library_ms=statistics.mean(fold_turns["sdpa"]))
        log(f"[kernels-parallel] ring fold-and-merge at L {RING_LENGTH} over {n} shards of {c}: out rel-L2 against "
            f"A over the whole sequence {rel:.3e} (tol {RING_REL_TOL}) | control, last shard dropped: {control:.3e} "
            f"(must exceed it) | a fold (A at L {c}) {fold_ms:.4f} ms (bound {bound[0]:.4f} ms, {bound[1]}), a "
            f"merge {merge_ms:.4f} ms, a rank's {n} folds and merges {rank_ms:.4f} ms against A over the whole "
            f"sequence {whole_ms:.4f} ms / {n} = {whole_ms / n:.4f} ms ({rank_ms / (whole_ms / n):.3f}x) | a fold "
            f"in turns {' '.join(f'{t:.4f}' for t in fold_turns['fold'])}, SDPA fwd on it "
            f"{' '.join(f'{t:.4f}' for t in fold_turns['sdpa'])} ms")
        if not rel <= RING_REL_TOL:
            raise AssertionError(f"ring over {n} shards disagrees with A over the whole sequence: {rel}")
        if not control > RING_REL_TOL:
            raise AssertionError(f"ring over {n} shards: the dropped-shard control passes ({control})")
        ring_rows.append(row)
        del outs, merged, shards, ks, vs, q0, k0, v0, q0s, k0s, v0s, fold, state
    del q, k, v, whole

    # B on T5-XXL's tensor-parallel shards: q/k/v and wi column-split, o and
    # wo row-split (M 256, g128); rank 0's shard, as parallel/sharding cuts it
    for label, key, role, k_dim, n_dim in (("qkvo_col", "q", "col", 4096, 4096), ("wi_col", "wi_0", "col", 4096, 10240),
                                           ("qkvo_row", "o", "row", 4096, 4096), ("wo_row", "wo", "row", 10240, 4096)):
        w = torch.randn((k_dim, n_dim), generator=g, device=dev) / k_dim ** 0.5
        whole = quantize_dense({"kernel": w}, bits=4, group_size=128, pack=True)
        del w
        xw = torch.randn((256, k_dim), generator=g, device=dev).to(torch.bfloat16)
        whole_ms = None
        for n in (2, 4):
            p = shard_dense(whole, key, role, n, 0)
            x = xw if role == "col" else xw[:, :k_dim // n].contiguous()
            kk = x.shape[1]
            if not im.supported(kk, p["kernel_scale"]):
                raise AssertionError(f"B does not take the {label} shard at n {n} ({kk}, {p['kernel_scale'].shape})")
            out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
            ref = im.int4_matmul_reference(x.float(), p["kernel_q4"], p["kernel_scale"])
            err = (out.float() - ref).abs().max().item()
            tol = INT4_REL_TOL * ref.abs().max().item()
            lw, lgs, ltable = _tinygemm_operands(p["kernel_q4"], p["kernel_scale"])
            turns = in_turns({"shard": lambda: im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"]),
                              "whole": lambda: im.int4_matmul(xw, whole["kernel_q4"], whole["kernel_scale"]),
                              "tinygemm": lambda: torch._weight_int4pack_mm(x, lw, lgs, ltable)})
            ms, full_ms = statistics.mean(turns["shard"]), statistics.mean(turns["whole"])
            library_ms = statistics.mean(turns["tinygemm"])
            plain_ms = time_ms(lambda: im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"]))
            nn_ = p["kernel_q4"].shape[1]
            bound = bound_ms(2 * 256 * kk * nn_, 2 * 256 * (kk + nn_) + p["kernel_q4"].numel()
                             + p["kernel_scale"].numel() * 4)
            row = dict(case=f"{label}_n{n}", k=kk, n=nn_, max_abs_err=err, tol=tol, ms=ms, whole_ms=full_ms,
                       turns_ms=turns, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1],
                       bound_share=bound[0] / ms, whole_share=ms / full_ms)
            log(f"[kernels-parallel] B {label} shard n {n} (M 256, K {kk}, N {nn_}, g128): max|Δ| {err:.3e} (tol "
                f"{tol:.3e}) | in turns: shard {' '.join(f'{t:.4f}' for t in turns['shard'])}, whole weight "
                f"{' '.join(f'{t:.4f}' for t in turns['whole'])} ms ({ms / full_ms:.3f} of it, 1/{n} = {1 / n:.3f}), "
                f"tinygemm on the shard {' '.join(f'{t:.4f}' for t in turns['tinygemm'])} ms | "
                f"{100 * bound[0] / ms:.1f}% of the bound {bound[0]:.4f} ms ({bound[1]}) | plain {plain_ms:.4f} ms")
            if not err <= tol:
                raise AssertionError(f"B {label} shard n {n} disagrees with its plain version: {err} > {tol}")
            b_rows.append(row)
            del lw, ltable
        del whole, xw
    seconds = time.perf_counter() - t_phase
    log(f"[kernels-parallel] {seconds:.1f} s")
    return {"flash_attention_tp": rows, "ring_fold_merge": ring_rows, "int4_matmul_tp": b_rows,
            "kernels_parallel_s": seconds}


def _tokenize_us(tok, prompts, reps: int = 50) -> float:
    """Host µs a prompt of tok.encode, warm (the Python BPE keeps a word cache)."""
    for text in prompts:
        tok.encode(text)
    t0 = time.perf_counter()
    for _ in range(reps):
        for text in prompts:
            tok.encode(text)
    return (time.perf_counter() - t0) * 1e6 / (reps * len(prompts))


def _small_dev_pipeline(pipe, t5_tok, clip_tok):
    """Flux-dev's flow at full width cut to 2 + 2 blocks, on random weights,
    with main's T5-XXL (int4), CLIP-L and VAE."""
    import dataclasses

    import torch

    from flux_generator_tpu_torch.io.registry import flux_configs
    from flux_generator_tpu_torch.models.flux.model import init_flux
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    cfg = dataclasses.replace(flux_configs("flux-dev")[0], depth=2, depth_single_blocks=2)
    g = torch.Generator(device="cuda").manual_seed(31)
    params = dict(pipe.params, flow=init_flux(g, cfg, torch.bfloat16, torch.device("cuda")))
    return FluxPipeline("flux-dev", params, cfg, pipe.ae_cfg, pipe.clip_cfg, pipe.t5_cfg, clip_tok, t5_tok)


def _train_small(pipe, out_dir):
    """One optimizer step (4 micro-steps) of main-train's arguments on the
    small-depth pipeline → (losses, LoRA tensors)."""
    import numpy as np

    from flux_generator_tpu_torch.io.params import tree_leaves
    from flux_generator_tpu_torch.training.dreambooth import build_parser, train
    from flux_generator_tpu_torch.training.lora import extract_lora

    args = build_parser().parse_args([out_dir, *TRAIN_ARGS, "--output-dir", out_dir, "--iterations", "1",
                                      "--checkpoint-every", "0"])
    rng = np.random.default_rng(77)
    dataset = [(rng.integers(0, 256, (576, 640, 3), dtype=np.uint8), p) for p in TRAIN_PROMPTS]
    trace = {}
    trained = train(args, pipeline=pipe, dataset=dataset, trace=trace)
    return trace["losses"], [t.detach().clone() for t in tree_leaves(extract_lora(trained.params["flow"]))]


def phase_main_parallel(pipe, latents, latent_2048):
    """The parallel entry points at world 1 on main's full-width pipeline
    (int8 flow, int4 T5-XXL), under an NCCL group of one process: a 512²
    request after shard() (tensor parallel over a model axis of 1: every
    row-parallel dense's sum and each modulation's gather go through NCCL)
    and one after enable_pipeline_parallel() (one stage), each equal byte
    for byte to main's request at its seed with 228 A and 168 B launches; a
    2048² request with enable_ring_attention(threshold=16384) (every
    attention of the request, L 16640, as a ring of one fold) against
    main-2048's latent; a small-depth Flux-dev dreambooth.train step under
    the group against the same step before it; main's prompts through the
    native and the Python tokenizer engines. The group is destroyed at the
    end."""
    import tempfile

    import torch

    from flux_generator_tpu_torch.io.registry import FLUX_T5_MAX_LENGTH
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
    from flux_generator_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    failures, rec = [], {"launches": {"flash_attention": 0, "flash_attention_rope": 0, "int4_matmul": 0}}
    blocks = pipe.flow_cfg.depth + pipe.flow_cfg.depth_single_blocks
    seed, prompt = PROMPTS[0]

    # the tokenizer engines on main's prompts
    t5_max = FLUX_T5_MAX_LENGTH["flux-schnell"]
    engines = {}
    for engine in ("native", "python"):
        t0 = time.perf_counter()
        t5 = load_t5_tokenizer(ROOT / "tests/assets/spiece/t5_like.model", max_length=t5_max, engine=engine)
        clip = load_clip_tokenizer(ROOT / "tests/assets/clip_tokenizer/vocab.json",
                                   ROOT / "tests/assets/clip_tokenizer/merges.txt", engine=engine)
        engines[engine] = dict(t5=t5, clip=clip, load_s=time.perf_counter() - t0)
    texts = [p for _, p in PROMPTS]
    same = all(engines["native"][m].encode(t) == engines["python"][m].encode(t) for m in ("t5", "clip") for t in texts)
    tok = {engine: {m: _tokenize_us(e[m], texts) for m in ("t5", "clip")} | {"load_s": e["load_s"]}
           for engine, e in engines.items()}
    log(f"[main-parallel] tokenizers on main's {len(texts)} prompts: native ids equal to the Python engine's "
        f"{same} | host µs a prompt, warm: T5 native {tok['native']['t5']:.1f}, Python {tok['python']['t5']:.1f}; "
        f"CLIP native {tok['native']['clip']:.1f}, Python {tok['python']['clip']:.1f} | load (the native library "
        f"built or loaded first) {tok['native']['load_s']:.3f} s against {tok['python']['load_s']:.3f} s")
    if not same:
        failures.append("the native tokenizers' ids differ from the Python engines'")
    rec["tokenizers"] = dict(equal=same, **tok)

    # the training step before the group exists
    small = _small_dev_pipeline(pipe, engines["native"]["t5"], engines["native"]["clip"])
    with tempfile.TemporaryDirectory() as out_dir:
        ungrouped = _train_small(small, out_dir)
    del small

    with tempfile.TemporaryDirectory() as init_dir:
        t0 = time.perf_counter()
        distributed.initialize_multihost(init_method=f"file://{init_dir}/group", num_processes=1, process_id=0)
        rec["init_s"] = time.perf_counter() - t0
        try:
            info = distributed.process_info()
            backend = torch.distributed.get_backend()
            log(f"[main-parallel] process group: {backend}, {info} ({rec['init_s']:.3f} s)")
            if backend != "nccl":
                failures.append(f"backend {backend}, want nccl")

            def request(tag):
                fa.launches = fa.rope_launches = im.launches = 0
                img, trace, latency = _flux_request(pipe, seed, prompt)
                n = {"flash_attention": fa.launches, "int4_matmul": im.launches}
                equal = torch.equal(trace["latent"], latents[seed])
                log(f"[main-parallel] {tag} 512² seed {seed}: {latency:.4f} s | launches A {n['flash_attention']} "
                    f"B {n['int4_matmul']} (want {blocks * STEPS}, 168) | final latent equal to main's byte for "
                    f"byte {equal}")
                if not equal:
                    failures.append(f"{tag}: the latent differs from main's")
                if n != {"flash_attention": blocks * STEPS, "int4_matmul": 24 * 7}:
                    failures.append(f"{tag}: launches {n}")
                rec[tag] = dict(latency_s=latency, launches=n, equal_to_main=equal)
                for key, count in dict(n, flash_attention_rope=fa.rope_launches).items():
                    rec["launches"][key] += count

            pipe.shard()
            _flux_request(pipe, seed, prompt)  # warm-up: NCCL sets up its communicator at the first collective
            request("shard")
            pipe.tp = None
            pipe.enable_pipeline_parallel()
            request("pipeline_parallel")
            pipe.pp = None

            pipe.enable_ring_attention(threshold=16384)
            fa.launches = fa.rope_launches = im.launches = 0
            torch.cuda.reset_peak_memory_stats()
            img, x_t, split = _timed_request_2048(
                pipe, pipe.generate_latents("an aerial photograph of a harbour town at golden hour",
                                            num_steps=STEPS, latent_size=(256, 256), seed=21), (256, 256),
                "conditioning_s")
            pipe.ring = None
            n = {"flash_attention": fa.launches, "flash_attention_rope": fa.rope_launches, "int4_matmul": im.launches}
            rel = _rel(x_t.float(), latent_2048.float())
            equal = torch.equal(x_t, latent_2048)
            log(f"[main-parallel] ring 2048² (threshold 16384, one fold): wall {split['wall_s']:.4f} s (denoise "
                f"{split['denoise_s']:.4f}) | peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches "
                f"{n} | final latent against main-2048's: rel-L2 {rel:.3e}, byte for byte {equal}")
            if not equal:
                failures.append(f"ring 2048²: the latent differs from main-2048's (rel-L2 {rel})")
            if n != {"flash_attention": blocks * STEPS, "flash_attention_rope": blocks * STEPS, "int4_matmul": 168}:
                failures.append(f"ring 2048²: launches {n}")
            rec["ring_2048"] = dict(split, launches=n, rel_l2=rel, equal_to_main_2048=equal)
            for key, count in n.items():
                rec["launches"][key] += count

            small = _small_dev_pipeline(pipe, engines["native"]["t5"], engines["native"]["clip"])
            with tempfile.TemporaryDirectory() as out_dir:
                grouped = _train_small(small, out_dir)
            del small
            same_loss = ungrouped[0] == grouped[0]
            same_lora = all(torch.equal(a, b) for a, b in zip(ungrouped[1], grouped[1]))
            log(f"[main-parallel] dreambooth.train, Flux-dev 2 + 2 blocks, one step of 4 micro-steps: losses "
                f"{' '.join(f'{x:.6f}' for x in grouped[0])} under the group, equal to the step before it "
                f"{same_loss}; adapters equal byte for byte {same_lora}")
            if not (same_loss and same_lora):
                failures.append(f"train under the group: losses equal {same_loss}, adapters equal {same_lora}")
            rec["train"] = dict(losses=grouped[0], equal_losses=same_loss, equal_adapters=same_lora)
        finally:
            pipe.tp = pipe.pp = pipe.ring = None
            distributed.shutdown()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[main-parallel] {rec['seconds']:.1f} s")
    if failures:
        raise AssertionError("main-parallel: " + "; ".join(failures))
    return rec


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
                "flash_attention_int8_quant": 2 * STEPS * {"qk": 1, "full": 2}[attn_int8],
                "int4_matmul": 2 * 7, "w8a8_matmul": 12 * STEPS if w8a8 == "fused" else 0,
                "w8a8_quantize_rows": 13 * STEPS if w8a8 == "rows" else 0}
        if any(n[key] != v for key, v in want.items()):
            raise AssertionError(f"small W8A8 config {w8a8}+{attn_int8}: launches {n}, want {want}")
        out[f"{w8a8}+{attn_int8}"] = res
    return out


def phase_kernels_musicgen():
    """Kernels C and D against their plain versions at MusicGen-medium shapes:
    the EnCodec LSTM (d = 1024, T = 497 and 2497 frames, B = 1; in turns
    with its route and cuDNN, with its serial floor and phase split) and the 48-layer decode
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

    # C at a 500-step request's shape (T 497, 2 a request), a 2500-step
    # request's (T 2497) and a small d in f32: against its plain version, two
    # calls bit for bit, and in turns (queued) with its route (the input
    # projection x·Wx + b, then the kernel) and cuDNN's nn.LSTM, which also
    # computes that projection, its weights compacted once into cuDNN's
    # one-buffer layout so that no call copies them (flatten_parameters()
    # skips bf16, which torch.backends.cudnn does not list as acceptable, so
    # the layout is made directly); its serial floor (T flagged exchanges of
    # h across the same grid, no gate math) and its per-step phase split
    lstm_cases = []
    for label, d, t, b, wd in (("d1024_T497_bf16", 1024, 497, 1, torch.bfloat16),
                               ("d1024_T2497_bf16", 1024, 2497, 1, torch.bfloat16),
                               ("d512_T497_f32", 512, 497, 1, torch.float32)):
        x = torch.randn((b, t, d), generator=g, device=dev)
        p = {"wx": torch.randn((d, 4 * d), generator=g, device=dev) / d ** 0.5,
             "wh": torch.randn((d, 4 * d), generator=g, device=dev) / d ** 0.5,
             "bias": torch.randn((4 * d,), generator=g, device=dev) * 0.1}
        xw, wh = lk._project(p, x)
        out = lk.lstm_recurrence(xw, wh, torch.float32)
        again = lk.lstm_recurrence(xw, wh, torch.float32)
        ref = lk.lstm_recurrence_plain(xw, wh, torch.float32)
        err = (out - ref).abs().max().item()
        repeatable = torch.equal(out, again)
        tol = LSTM_TOL["bf16" if wd == torch.bfloat16 else "f32"]
        plain_ms = time_ms(lambda: lk.lstm_recurrence_plain(xw, wh, torch.float32), iters=2, warmup=1)
        cudnn = torch.nn.LSTM(d, d, batch_first=True).to(dev, wd)
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(cudnn._flat_weights, 4, d,
                                            cudnn_rnn.get_cudnn_mode("LSTM"), d, 0, 1,
                                            True, False)
        x_in = x.to(wd)
        with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cudnn(x_in)
            compacted = not any("compacted at every call" in str(w.message) for w in caught)
            turns = in_turns({"kernel": lambda: lk.lstm_recurrence(xw, wh, torch.float32),
                              "route": lambda: lk.lstm(p, x),
                              "cudnn": lambda: cudnn(x_in)}, iters=5)
            # queued, cuDNN's time holds its host launches; its device time does not
            library_ms = device_ms(lambda: cudnn(x_in), iters=5)
        ms, route_ms = (statistics.mean(turns[k]) for k in ("kernel", "route"))
        floor_ms = time_ms_queued(lambda: lk.exchange_floor(b, t, d, dev), iters=5)
        phases = lk.phase_times(xw, wh)
        # xw and Wh read, f32 h written; 2·d·4d operations a step
        bound = bound_ms(2 * t * b * d * 4 * d, xw.numel() * xw.element_size()
                         + wh.numel() * wh.element_size() + b * t * d * 4)
        log(f"[kernels] lstm {label}: max|Δ| {err:.3e} (tol {tol}), two calls equal {repeatable} | in turns: "
            f"kernel " + " ".join(f"{v:.4f}" for v in turns["kernel"]) + f" ms ({ms * 1e3 / t:.3f} us/step), "
            "route (projection + kernel) " + " ".join(f"{v:.4f}" for v in turns["route"]) + " ms, cuDNN LSTM "
            + " ".join(f"{v:.4f}" for v in turns["cudnn"]) + f" ms ({library_ms:.4f} ms device time; weights "
            f"compacted once: {compacted}) | "
            f"serial floor {floor_ms:.4f} ms ({floor_ms * 1e3 / t:.3f} us/step; kernel {ms / floor_ms:.2f}x) | "
            f"split, us/step: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
            + f" | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]})")
        if not (err <= tol and repeatable):
            failures.append(f"lstm {label}: {err} > {tol} or two calls differ ({repeatable})")
        lstm_cases.append(dict(case=label, max_abs_err=err, repeatable=repeatable, ms=ms, ms_in_turns=turns["kernel"],
                               route_ms_in_turns=turns["route"], library_ms_in_turns=turns["cudnn"],
                               route_ms=route_ms, plain_ms=plain_ms, library_ms=library_ms,
                               library_weights_compacted=compacted, serial_floor_ms=floor_ms,
                               phase_us_per_step=phases, bound_ms=bound[0], bound_by=bound[1]))
        del x, p, xw, wh, out, again, ref, cudnn, x_in
    results["lstm"] = lstm_cases
    # EnCodec's 2 LSTM layers run once a request, at T = steps - 3 frames
    per_request = {c["case"]: 2 * c["ms"] for c in lstm_cases if c["case"].startswith("d1024")}
    log("[kernels] lstm a request's 2 launches: " + ", ".join(f"{k} {v:.4f} ms" for k, v in per_request.items()))
    results["lstm_request_ms"] = per_request
    # C with Wh in shared memory, the route of a card with fewer than 128 SMs
    # at d 1024 (here an H100 PCIe's 114, forced) and of any d > 1024: bit for
    # bit the register route at d 1024 T 497, queued in turns with it, and at
    # d 1536 against the plain version
    xw, wh = (torch.randn((1, 497, 4096), generator=g, device=dev) * 0.5).to(torch.bfloat16), \
        (torch.randn((1024, 4096), generator=g, device=dev) / 32).to(torch.bfloat16)
    pcie = lk.lstm_geometry(1024, 114)
    shared = lk._run(xw, wh, torch.float32, geometry=pcie)
    same = torch.equal(shared, lk.lstm_recurrence(xw, wh, torch.float32))
    turns = in_turns({"registers": lambda: lk.lstm_recurrence(xw, wh, torch.float32),
                      "shared": lambda: lk._run(xw, wh, torch.float32, geometry=pcie)}, iters=5)
    xw, wh = (torch.randn((1, 60, 6144), generator=g, device=dev) * 0.5).to(torch.bfloat16), \
        (torch.randn((1536, 6144), generator=g, device=dev) / 1536 ** 0.5).to(torch.bfloat16)
    wide_err = (lk.lstm_recurrence(xw, wh, torch.float32)
                - lk.lstm_recurrence_plain(xw, wh, torch.float32)).abs().max().item()
    log(f"[kernels] lstm Wh in shared memory: d 1024 T 497 at 114 SMs' launch {pcie} equal to the register route "
        f"{same}, in turns (ms, queued): registers " + " ".join(f"{v:.4f}" for v in turns["registers"])
        + ", shared " + " ".join(f"{v:.4f}" for v in turns["shared"])
        + f" | d 1536 T 60 max|Δ| {wide_err:.3e} (tol {LSTM_TOL['bf16']})")
    if not (same and wide_err <= LSTM_TOL["bf16"]):
        failures.append(f"lstm Wh in shared memory: equal to the register route {same}, d 1536 max|Δ| {wide_err}")
    results["lstm_shared_memory_route"] = dict(geometry_114_sms=list(pcie), equal_to_register_route=same,
                                               ms_in_turns=turns, d1536_max_abs_err=wide_err)
    del xw, wh, shared

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
            # in turns with #11, D's weight stream on D's own machinery alone, at the same rows and weights
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
    """The decode-chain probe (#11, on D's machinery) against its plain
    version at 48 layers, M 8, 5, 2 and 1, on the probe's own inputs, with a
    control that must miss (the plain chain without its last layer); its
    bits over 50 calls in a row, and each row of an M-8 call against an M-1
    call on that row. Then the attribution: #11 at M 2 and M 8 in turns with
    kernel D (int8 weights, the same ones, bf16 cache) at B 2 (W 500,
    offset 250) and B 8 (W 2048, offset 1900), D − #11, and one launch's
    phase split of each from block 0's device clock; then one run of the
    probe's entry point, whose launches are the line's."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.scripts import prof_decode_chain as probe

    dev = torch.device("cuda")
    L, H, heads = 48, probe.H, 24
    w, s, x = probe.make_inputs(L, dev)
    failures, errs = [], {}
    for m in (8, 5, 2, 1):
        xm = x[:m].contiguous()
        y = dc.decode_chain(w, s, xm)
        ref = dc.decode_chain_plain(w, s, xm).float()
        short = dc.decode_chain_plain(w[:-14], s[:-14], xm).float()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        errs[m] = (y.float() - ref).abs().max().item()
        control = (y.float() - short).abs().max().item() / scale
        log(f"[kernels-chain] decode chain L48 M{m}: max|Δ| {errs[m]:.3e} (tol {CHAIN_REL_TOL * scale:.3e}); "
            f"control, the plain chain without its last layer, {control:.3e} of max (must miss {CHAIN_REL_TOL})")
        if not (errs[m] <= CHAIN_REL_TOL * scale and control > CHAIN_REL_TOL and torch.isfinite(y.float()).all()):
            failures.append(f"M {m}: {errs[m]} (tol {CHAIN_REL_TOL * scale}), control {control}")
    first = dc.decode_chain(w, s, x)
    repeat = all(torch.equal(first.view(torch.int16), dc.decode_chain(w, s, x).view(torch.int16)) for _ in range(50))
    rows = all(torch.equal(first[r:r + 1].view(torch.int16), dc.decode_chain(w, s, x[r:r + 1].contiguous()).view(
        torch.int16)) for r in range(8))
    log(f"[kernels-chain] bits equal over 50 calls {repeat}; each row of M 8 equal to an M-1 call {rows}")
    if not (repeat and rows):
        failures.append(f"bits over 50 calls {repeat}, rows independent of M {rows}")
    info = dc.kernel_info()
    syncs = info["syncs_per_layer"] * L
    g = torch.Generator(device=dev).manual_seed(91)
    packed = {"w": w, "s": s, "ln": (1 + 0.1 * torch.randn((L, 8, H), generator=g, device=dev)).to(torch.bfloat16)}
    attribution, cases = {}, {}
    for m, window, offset in ((2, 500, 250), (8, 2048, 1900)):
        xm = x[:m].contiguous()
        xd = torch.randn((m, H), generator=g, device=dev).to(torch.bfloat16)
        ck = torch.randn((L, m, 16, H), generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn((L, m, window, H), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((L, m, window, H), generator=g, device=dev).to(torch.bfloat16)
        chain = lambda: dc.decode_chain(w, s, xm)  # noqa: E731
        step = lambda: ds.fused_decode_step(packed, xd, ck, ck, offset, kc, vc, n_heads=heads)  # noqa: E731
        t = [time_ms(f) for f in (chain, step, step, chain) * 2]
        ms, d_ms = statistics.mean(t[0::4] + t[3::4]), statistics.mean(t[1::4] + t[2::4])
        d_split = ds.phase_times(packed, xd, ck, ck, offset, kc, vc, n_heads=heads)
        chain_split = dc.phase_times(w, s, xm)
        nbytes = probe.step_bytes(L, m)
        bound = bound_ms(2 * m * w.numel(), nbytes)
        attribution[m] = dict(d_ms=d_ms, chain_ms=ms, d_minus_chain_ms=d_ms - ms, d_window=window, d_offset=offset,
                              d_phase_us=d_split, chain_phase_us=chain_split)
        cases[m] = dict(ms=ms, ms_in_turns=t[0::4] + t[3::4], d_ms_in_turns=t[1::4] + t[2::4], bytes=nbytes,
                        bound_ms=bound[0], bound_by=bound[1], bound_share=bound[0] / ms, syncs_per_step=syncs,
                        us_per_phase=ms * 1e3 / syncs)
        log(f"[kernels-chain] M {m}: #11 {ms:.4f} ms ({' '.join(f'{v:.4f}' for v in cases[m]['ms_in_turns'])}), "
            f"bound {bound[0]:.4f} ms ({bound[1]}; {bound[0] / ms:.1%} of it), {syncs} grid syncs a step, "
            f"{ms * 1e3 / syncs:.2f} us a phase | D (B {m}, W {window}, offset {offset}) in turns {d_ms:.4f} ms: "
            f"D − #11 {d_ms - ms:+.4f} ms")
        log(f"[kernels-chain] M {m} phase split, us a step: #11 " + ", ".join(
            f"{k} {v:.1f}" for k, v in chain_split.items()) + f" (sum {sum(chain_split.values()):.1f}) | D "
            + ", ".join(f"{k} {v:.1f}" for k, v in d_split.items()) + f" (sum {sum(d_split.values()):.1f})")
        del xd, ck, kc, vc
    plain_ms = time_ms(lambda: dc.decode_chain_plain(w, s, x), iters=2, warmup=1)
    err = max(errs.values())
    del packed, w, s, x, first
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("the decode chain disagrees with its plain version: " + "; ".join(failures))
    dc.launches = 0
    run = probe.run(layers=L, steps=50)
    launches = dc.launches
    log(f"[kernels-chain] probe entry point (48 layers, 50 steps; {launches} launches): " + " | ".join(
        f"M {c['rows']} rel err {c['rel_err']:.3e}, {c['ms']:.4f} ms/step, {c['bound_share']:.1%} of the bound, "
        f"{c['us_per_phase']:.2f} us a phase" for c in run["cases"]) + f" | plain at M 8 {run['plain_ms']:.4f} ms")
    if not (run["rel_err"] <= CHAIN_REL_TOL and run["finite"] and launches > 0):
        raise AssertionError(f"the probe's run failed: {run}, {launches} launches")
    return {"decode_chain": [dict(case="L48_M8", max_abs_err=err, ms=cases[8]["ms"], m2_ms=cases[2]["ms"],
                                  plain_ms=plain_ms, library_ms=None, bound_ms=cases[8]["bound_ms"],
                                  bound_by=cases[8]["bound_by"], cases=cases, kernel=info, attribution=attribution,
                                  probe=run, launches=launches)]}


def phase_kernels_chain_bisect(chain):
    """The chain-bisect probe (#12, on D's machinery) against its plain
    version at 48 layers, M 8, 5, 2 and 1 (M 1 without outs, which writes
    two rows), for each of its eight cumulative rungs, on #11's weights and
    seeded random LN params, cross K/V and caches (W 512, chunk 512); at M 8
    and M 2 each rung timed in turns with #11 (#11, rung, rung, #11 twice
    over). A control must miss the tolerance: the no-extras rung's output
    against the ln rung's plain output. Then the attribution at M 2 and M 8:
    D − #11 from `chain` (kernels-chain's record), and each rung's cost over
    #11 less the rung before's; and one run of the probe's entry point (the
    script's ladder, then every extra, at M 8 and M 2), whose launches are
    the line's."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import chain_bisect as cb
    from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
    from flux_generator_tpu_torch.scripts import prof_chain_bisect as probe
    from flux_generator_tpu_torch.scripts import prof_decode_chain as chain_probe

    dev = torch.device("cuda")
    L, H, window = 48, probe.H, 512
    w, s, x8 = chain_probe.make_inputs(L, dev)
    every = probe.make_extra_operands(cb.RUNGS[-1], L, window, dev)
    cases, failures = [], []
    for m in (8, 5, 2, 1):
        x = x8[:m].contiguous()
        for spec in cb.RUNGS:
            ex = cb.parse_extras(spec)
            if "outs" in ex and m < cb.B:
                continue
            ops = {k: v for k, v in every.items() if cb.OPERAND_EXTRA[k] in ex}
            got = cb.chain_bisect(w, s, x, spec, **ops)
            ref = cb.chain_bisect_plain(w, s, x, spec, **ops)
            torch.cuda.synchronize()
            errs = probe.rel_errors(got, ref)
            y = got[0] if isinstance(got, tuple) else got
            yr = ref[0] if isinstance(ref, tuple) else ref
            abs_err = (y.float() - yr.float()).abs().max().item()
            finite = all(bool(torch.isfinite(t.float()).all()) for t in (got if isinstance(got, tuple) else (got,)))
            if not (max(errs.values()) <= CHAIN_REL_TOL and finite):
                failures.append(f"M {m} rung {spec!r}: {errs}, finite {finite}")
            if m in (5, 1):  # checked, not timed
                log(f"[kernels-chain-bisect] M {m} rung {spec or '-'}: max|Δ|/max {errs} (tol {CHAIN_REL_TOL})")
                continue
            rung = lambda: cb.chain_bisect(w, s, x, spec, **ops)  # noqa: E731
            chain11 = lambda: dc.decode_chain(w, s, x)  # noqa: E731
            t = [time_ms(f, iters=30) for f in (chain11, rung, rung, chain11) * 2]
            ms, chain_ms = statistics.mean(t[1::4] + t[2::4]), statistics.mean(t[0::4] + t[3::4])
            plain_ms = time_ms(lambda: cb.chain_bisect_plain(w, s, x, spec, **ops), iters=2, warmup=1)
            nbytes = probe.step_bytes(spec, L, m, window)
            bound = bound_ms(2 * m * w.numel(), nbytes)
            plan = cb.plan(m, H, spec)
            syncs = plan["syncs_per_layer"] * L
            log(f"[kernels-chain-bisect] M {m} rung {spec or '-'}: max|Δ|/max {errs} (tol {CHAIN_REL_TOL}) | "
                f"kernel {ms:.4f} ms, #11 in turns {chain_ms:.4f} ms ({ms - chain_ms:+.4f}) | plain {plain_ms:.4f} ms"
                f" | bound {bound[0]:.4f} ms ({bound[1]}, {nbytes / 1e9:.4f} GB; {bound[0] / ms:.1%} of it) | "
                f"{syncs} grid syncs a step, {ms * 1e3 / syncs:.2f} us a phase | grid {plan['grid']}, "
                f"{plan['blocks_per_sm']} blocks/SM, {plan['smem_bytes']} B shared a block")
            cases.append(dict(case=f"M{m}_{spec or 'none'}", rows=m, extras=spec, max_abs_err=abs_err, rel_errs=errs,
                              ms=ms, chain_ms_in_turns=chain_ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound[0],
                              bound_by=bound[1], bound_share=bound[0] / ms, syncs_per_step=syncs,
                              us_per_phase=ms * 1e3 / syncs, library_ms=None, **plan))
    ops = {k: v for k, v in every.items() if cb.OPERAND_EXTRA[k] in ("smem", "ln")}
    control = probe.rel_errors(cb.chain_bisect(w, s, x8, ""), cb.chain_bisect_plain(w, s, x8, "smem,ln", **ops))["y"]
    log(f"[kernels-chain-bisect] control: the no-extras kernel against the ln rung's plain version "
        f"{control:.3e} of max (must miss {CHAIN_REL_TOL})")
    if not control > CHAIN_REL_TOL:
        failures.append(f"the control passed the check: {control}")
    attribution = {}
    for m in (8, 2):
        rows = [c for c in cases if c["rows"] == m]
        excess = [c["ms"] - c["chain_ms_in_turns"] for c in rows]
        deltas = [excess[0]] + [b - a for a, b in zip(excess, excess[1:])]
        d = chain["attribution"][m]
        attribution[m] = dict(rungs=dict(zip([c["extras"] or "none" for c in rows], deltas)),
                              d_minus_chain_ms=d["d_minus_chain_ms"], d_ms=d["d_ms"], chain_ms=d["chain_ms"])
        log(f"[kernels-chain-bisect] M {m} attribution: D − #11 {d['d_minus_chain_ms']:+.4f} ms (kernels-chain: D "
            f"{d['d_ms']:.4f} at B {m}, W {d['d_window']}, offset {d['d_offset']}; #11 {d['chain_ms']:.4f}) | each "
            f"rung over the one before (the first over #11): " + ", ".join(
                f"{k} {v:+.4f}" for k, v in attribution[m]["rungs"].items()) + f" | sum {sum(deltas):+.4f} ms")
    del w, s, x8, every, ops
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("the chain bisect disagrees with its plain version: " + "; ".join(failures))
    cb.launches = 0
    runs = probe.run(ladder=True, steps=50)["rungs"] + probe.run(cb.RUNGS[-1], steps=50)["rungs"]
    launches = cb.launches
    for r in runs:
        log(f"[kernels-chain-bisect] entry point M {r['rows']} rung {r['extras'] or '-'}: rel err "
            f"{r['rel_err']:.3e}, {r['ms']:.4f} ms/step, {r['bound_share']:.1%} of the bound "
            f"{r['bound_ms']:.4f} ms, {r['syncs_per_step']} syncs, {r['us_per_phase']:.2f} us a phase")
    log(f"[kernels-chain-bisect] entry point (the script's ladder, then every extra; 48 layers, 50 steps): "
        f"{launches} launches")
    if not (all(r["rel_err"] <= CHAIN_REL_TOL and r["finite"] for r in runs) and launches > 0):
        raise AssertionError(f"the probe's run failed: {runs}, {launches} launches")
    return {"chain_bisect": dict(cases=cases, control_rel_err=control, attribution=attribution, probe=runs,
                                 launches=launches)}


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
    """One 2500-step request (about 50 s of audio) on bf16 caches, then on
    e4m3 caches, with the device ms a step over its first and last 250
    steps."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    codec = pipe.audio_decoder.cfg
    want = ((LONG_STEPS - pipe.cfg.num_codebooks + 1) * codec.hop_length, codec.audio_channels)
    audio_s = want[0] / pipe.sampling_rate
    runs, f8_launches = [], 0
    for kv in ("bf16", "f8"):
        pipe.kv_dtype = kv
        torch.cuda.reset_peak_memory_stats()
        ds.launches = ds.e4m3_launches = lk.launches = 0
        trace = {}
        t0 = time.perf_counter()
        audio = pipe.generate(SERVE_TEXTS[-1], max_steps=LONG_STEPS, top_k=MG_TOP_K, seed=7, trace=trace,
                              step_times=True)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        dec_n, f8_n, lstm_n = ds.launches, ds.e4m3_launches, lk.launches
        f8_launches += f8_n
        steps = trace["step_ms"]
        finite = bool(torch.isfinite(audio).all())
        rec = dict(kv_dtype=kv, latency_s=latency, conditioning_s=trace["conditioning_s"], ar_s=trace["ar_s"],
                   decode_s=trace["decode_s"], ms_per_step=trace["ar_s"] * 1e3 / LONG_STEPS,
                   first_250_ms_per_step=statistics.mean(steps[:250]),
                   last_250_ms_per_step=statistics.mean(steps[-250:]), audio_s=audio_s,
                   audio_s_per_s=audio_s / latency, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   decode_step_launches=dec_n, lstm_launches=lstm_n, shape=list(audio.shape), finite=finite)
        log(f"[main-musicgen-long] {kv} caches, {LONG_STEPS} steps: {latency:.4f} s (AR {rec['ar_s']:.4f}, "
            f"decode {rec['decode_s']:.4f}) | device ms/step first 250 {rec['first_250_ms_per_step']:.4f}, "
            f"last 250 {rec['last_250_ms_per_step']:.4f} | {rec['audio_s_per_s']:.2f} audio-s/s | peak "
            f"{rec['peak_gib']:.2f} GiB | launches decode {dec_n} lstm {lstm_n} | finite {finite}")
        if tuple(audio.shape) != want or not finite or dec_n != LONG_STEPS \
                or f8_n != (LONG_STEPS if kv == "f8" else 0) or lstm_n != codec.num_lstm_layers:
            raise AssertionError(f"long request: waveform {tuple(audio.shape)} (want {want}), finite "
                                 f"{finite}, launches {dec_n} (e4m3 {f8_n}), lstm {lstm_n} (want "
                                 f"{codec.num_lstm_layers})")
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


# ------------------------------------------------------------ SD 2.1 and SDXL-Turbo


def _d64_geometry(fa, b: int, length: int, h: int) -> dict:
    """Kernel A's launch at head dim 64 on this card: the consumer
    warpgroups that `d64_geometry` picks, its tiles (64 rows a warpgroup),
    the rounds they take over the SMs (one CTA an SM), at three warpgroups
    `d64_split`'s CTAs and tail CTAs with the last round's tiles that are
    split over keys and their parts, and the exp floor (B·H·L² exponentials
    at PEAK_EXP_S)."""
    import torch

    sms = torch.cuda.get_device_properties(torch.device("cuda")).multi_processor_count
    w = fa.d64_geometry(b * h, length, sms)
    units = b * h * -(-length // (64 * w))
    ctas, tail, parts = min(units, sms), 0, []
    if w == 3:
        ctas, tail, _ = fa.d64_split(b * h, length, sms)
        parts = [p for p in fa.d64_tail(b * h, length, ctas, tail) if p > 1]
    return dict(warpgroups=w, units=units, rounds=units / sms, ctas=ctas, tail_ctas=tail, split_tiles=len(parts),
                parts=sorted(set(parts)), exp_floor_ms=b * h * length * length / PEAK_EXP_S * 1e3)


def _d64_split_note(geo: dict, merges: int) -> str:
    """The split of A's last round at one call, as the plan gives it and as
    the kernel's own merge count shows it; raises when the two disagree."""
    if merges != 3 * geo["split_tiles"]:
        raise AssertionError(f"flash at head dim 64: {merges} merges on the card, the plan splits "
                             f"{geo['split_tiles']} tiles (3 merges each)")
    if not geo["split_tiles"]:
        return f"{geo['ctas']} CTAs, no tile split"
    return (f"{geo['ctas']} CTAs, last round over {geo['tail_ctas']}: {geo['split_tiles']} tiles split into "
            f"{'/'.join(map(str, geo['parts']))} parts, split path ran ({merges} merges on the card)")


def phase_kernels_sd():
    """Kernel A's bf16 mode at head dim 64 without RoPE, at the UNet
    self-attention shapes of a 512² request (SD_ATTN_SHAPES): held to its
    plain version, the kernel and the route timed behind a sleep kernel, the
    plain version by CUDA events, the route in turns with SDPA's forward on
    the same q/k/v in (B, H, L, D)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for label, b, length, h, per_request in SD_ATTN_SHAPES:
        q, k, v = (torch.randn((b, length, h, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        merges = fa.d64_merges(dev)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        geo = _d64_geometry(fa, b, length, h)
        split_note = _d64_split_note(geo, fa.d64_merges(dev) - merges)
        ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float())
        out_abs, lse_err = (out.float() - ref).abs().max().item(), (lse - ref_lse).abs().max().item()
        rel = _rel(out.float(), ref)
        dropped, _ = fa.flash_attention_reference(q.float(), k[:, :-64].float(), v[:, :-64].float())
        control_rel = _rel(dropped, ref)
        err = max(out_abs, lse_err)
        del ref, ref_lse, dropped
        ms = time_ms_queued(lambda: fa.flash_attention_sm90(q, k, v))
        route_ms = time_ms_queued(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v), iters=5)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        turns = in_turns({"route": lambda: fa.flash_attention(q, k, v),
                          "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
        library_ms = statistics.mean(turns["sdpa"])
        flops = 4 * b * h * length * length * 64
        # q, k, v and out in bf16, lse in f32
        bound = bound_ms(flops, 4 * q.numel() * 2 + b * h * length * 4)
        row = dict(case=label, b=b, l=length, h=h, max_abs_err=err, out_rel_l2=rel, out_max_abs_err=out_abs,
                   lse_max_abs_err=lse_err, control_last_64_keys_dropped_out_rel_l2=control_rel, ms=ms,
                   route_ms=route_ms, plain_ms=plain_ms, library_ms=library_ms, turns_ms=turns, bound_ms=bound[0],
                   bound_by=bound[1], tflops=flops / 1e9 / ms, bound_share=bound[0] / ms,
                   launches_a_request=per_request, **geo)
        tol_out, tol_lse = SD_FLASH_TOL
        log(f"[kernels-sd] flash {label} (B {b}, L {length}, H {h}, D 64): out rel-L2 {rel:.3e} (tol {tol_out}), "
            f"max|Δ| {out_abs:.3e} of max|out| {out.float().abs().max().item():.3e} | lse max|Δ| {lse_err:.3e} "
            f"(tol {tol_lse}) | control, last 64 keys dropped: out rel-L2 {control_rel:.3e} (must exceed "
            f"{tol_out}) | {geo['warpgroups']} consumer warpgroups: {geo['units']} tiles, "
            f"{geo['rounds']:.2f} rounds, {split_note} | kernel "
            f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% of the bound "
            f"{bound[0]:.4f} ms, {bound[1]}; exp floor {geo['exp_floor_ms']:.4f} ms) | route {route_ms:.4f} ms | "
            f"plain {plain_ms:.4f} ms | in turns: "
            f"route {' '.join(f'{t:.4f}' for t in turns['route'])}, SDPA fwd "
            f"{' '.join(f'{t:.4f}' for t in turns['sdpa'])} ms | {per_request} a request")
        if not (rel <= tol_out and lse_err <= tol_lse):
            raise AssertionError(f"flash {label} disagrees with its plain version: out rel-L2 {rel}, lse {lse_err}")
        if not control_rel > tol_out:
            raise AssertionError(f"flash {label}: the control with 64 keys dropped passes ({control_rel})")
        rows.append(row)
        del q, k, v, qs, ks, vs, out, lse
    torch.cuda.synchronize()
    sums = {}
    for key in ("sd21", "sdxl_b1", "sdxl_b4"):
        mine = [r for r in rows if r["case"].startswith(key + "_")]
        sums[key] = {f: sum(r["launches_a_request"] * r[f] for r in mine)
                     for f in ("ms", "route_ms", "plain_ms", "library_ms", "bound_ms")}
        sums[key]["launches"] = sum(r["launches_a_request"] for r in mine)
        s = sums[key]
        log(f"[kernels-sd] a {key} request's {s['launches']} A calls: kernel {s['ms']:.3f} ms, route "
            f"{s['route_ms']:.3f}, SDPA {s['library_ms']:.3f}, plain {s['plain_ms']:.3f}, bound {s['bound_ms']:.3f}")
    return {"flash_attention_sd": rows, "flash_attention_sd_requests": sums}


def _sd_tokenizer():
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer

    return load_clip_tokenizer(ROOT / "tests/assets/clip_tokenizer/vocab.json",
                               ROOT / "tests/assets/clip_tokenizer/merges.txt")


def _sd_request(pipe, tag: str, texts, seeds, steps: int, cfg: float, image=None, strength: float = 0.5):
    """One request through the server's entry points: generate_latents_batch
    (or generate_latents_from_image when `image` is given) then decode_u8,
    ended by a synchronize → (record, uint8 images, final latent). Kernel
    A's launches are counted from 0 (the counts are set to 0 just before)."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    trace = {}
    t0 = time.perf_counter()
    if image is None:
        steps_it = pipe.generate_latents_batch(texts, seeds, num_steps=steps, cfg_weight=cfg,
                                               latent_size=(SIZE // 8, SIZE // 8), trace=trace)
    else:
        steps_it = pipe.generate_latents_from_image(image, texts[0], strength=strength, num_steps=steps,
                                                    cfg_weight=cfg, seed=seeds[0], trace=trace)
    lat, marks = None, []
    for lat in steps_it:
        marks.append(time.perf_counter())
    n_steps = len(marks)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = pipe.decode_u8(lat)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _launch_counts()
    setup = trace["conditioning_s"] + trace.get("encode_s", 0.0)
    rec = dict(batch=len(texts), steps=n_steps, cfg_weight=cfg, latency_s=t2 - t0,
               conditioning_s=trace["conditioning_s"], encode_s=trace.get("encode_s"),
               denoise_s=t1 - t0 - setup, decode_s=t2 - t1, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               flash_launches=fa.launches, shape=list(img.shape), dtype=str(img.dtype),
               latent_finite=bool(torch.isfinite(lat).all()))
    # the host's time between yields: the steps queue without a synchronize,
    # so on a host-bound path this is each step's time (the first is the
    # conditioning's and the prior's too)
    gaps = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    if gaps:
        rec["step_host_ms"] = dict(min=min(gaps), median=statistics.median(gaps), max=max(gaps))
    others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
    if fa.rope_launches:
        others["flash_attention_rope"] = fa.rope_launches
    log(f"[main-sd] {tag}: {rec['latency_s']:.4f} s (conditioning {rec['conditioning_s']:.4f}"
        + (f" + encode {rec['encode_s']:.4f}" if image is not None else "")
        + f" + denoise {rec['denoise_s']:.4f} ({n_steps} steps, {1e3 * rec['denoise_s'] / max(n_steps, 1):.2f} "
        f"ms a step) + decode {rec['decode_s']:.4f}) | peak {rec['peak_gib']:.2f} GiB | A launches "
        f"{fa.launches} | {tuple(img.shape)} {img.dtype} | latent finite {rec['latent_finite']}"
        + (" | host ms between steps: min {min:.2f}, median {median:.2f}, max {max:.2f}".format(**rec["step_host_ms"])
           if gaps else ""))
    if others:
        raise AssertionError(f"{tag}: kernels other than A launched: {others}")
    if tuple(img.shape) != (len(texts), SIZE, SIZE, 3) or img.dtype != torch.uint8 or not rec["latent_finite"]:
        raise AssertionError(f"{tag}: image {tuple(img.shape)} {img.dtype}, latent finite {rec['latent_finite']}")
    return rec, img, lat


def _sd_profile(pipe, tag: str, texts, seeds, steps: int, cfg: float) -> dict:
    """One request (generate_latents_batch + decode_u8) under torch.profiler:
    its wall time with the profiler on, the device's busy share and the
    device time by kernel group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lat = None
        for lat in pipe.generate_latents_batch(texts, seeds, num_steps=steps, cfg_weight=cfg,
                                               latent_size=(SIZE // 8, SIZE // 8)):
            pass
        pipe.decode_u8(lat)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rec = _profile_record(prof, 1, wall_ms, f"main-sd profile {tag}", "request",
                          f"{steps} steps, batch {len(texts)}, cfg {cfg}")
    rec["busy_share"] = rec["busy_ms"] / wall_ms
    return rec


def _sd_pipeline(cls, name: str, tag: str):
    """A full-width pipeline in bf16 on random weights (seed 0) with the
    CLIP tokenizer → (pipeline, set-up record)."""
    import torch

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = cls.random_init(name, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe.tokenizers = [_sd_tokenizer()] * len(pipe.clip_cfgs)
    setup = dict(init_s=init_s, resident_gib=torch.cuda.memory_allocated() / 2**30)
    log(f"[main-sd] {tag}: random init {init_s:.2f} s, resident {setup['resident_gib']:.2f} GiB | CLIP tokens: "
        f"the BPE test asset (tests/assets/clip_tokenizer), padded with 0 to 77")
    return pipe, setup


def phase_main_sd():
    """SD 2.1-base and SDXL-Turbo at full width on random weights (bf16),
    512², through the entry points the server drives
    (generate_latents_batch, generate_latents_from_image, decode_u8): SD 2.1
    at the server's 50 steps and cfg 4.0 (CFG: the UNet at batch 2), three
    requests; SDXL-Turbo at 2 steps without CFG at batch 1 (two requests)
    and batch 4 (a coalesce bucket), and an img2img at strength 0.5 on the
    first image (1 step). Exact A launch counts (15 an SD 2.1 UNet call, 70
    an SDXL one), finite latents, uint8 images of the shape asked; then one
    request of each under torch.profiler for the busy share (SD 2.1's at
    SD21_PROFILE_STEPS steps)."""
    import gc

    import torch

    from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL

    record = {}
    total = 0
    pipe, setup = _sd_pipeline(StableDiffusion, "stable-diffusion-2-1-base", "SD 2.1-base")
    t0 = time.perf_counter()
    _sd_request(pipe, "SD 2.1 warm-up (2 steps, not counted)", [SD_PROMPTS[0][1]], [0], 2, SD21_CFG)
    log(f"[main-sd] SD 2.1 warm-up {time.perf_counter() - t0:.3f} s")
    requests, images = [], []
    for seed, prompt in SD_PROMPTS[:3]:
        rec, img, _ = _sd_request(pipe, f"SD 2.1 request seed={seed}", [prompt], [seed], SD21_STEPS, SD21_CFG)
        want = 15 * SD21_STEPS
        if rec["flash_launches"] != want:
            raise AssertionError(f"SD 2.1 request: {rec['flash_launches']} A launches, want {want}")
        total += rec["flash_launches"]
        requests.append(dict(rec, seed=seed))
        images.append(img)
    if torch.equal(images[0], images[1]):
        raise AssertionError("SD 2.1 requests with different seeds gave identical images")
    record["sd21"] = dict(setup, requests=requests,
                          profile=_sd_profile(pipe, "SD 2.1", [SD_PROMPTS[0][1]], [SD_PROMPTS[0][0]],
                                              SD21_PROFILE_STEPS, SD21_CFG))
    del pipe, images
    gc.collect()
    torch.cuda.empty_cache()

    pipe, setup = _sd_pipeline(StableDiffusionXL, "sdxl-turbo", "SDXL-Turbo")
    _sd_request(pipe, "SDXL warm-up (not counted)", [SD_PROMPTS[0][1]], [0], SDXL_STEPS, 0.0)
    _sd_request(pipe, "SDXL warm-up, batch 4 (not counted)", [p for _, p in SD_PROMPTS], [0, 1, 2, 3],
                SDXL_STEPS, 0.0)
    requests, images = [], []
    for texts, seeds in (([SD_PROMPTS[0][1]], [SD_PROMPTS[0][0]]), ([SD_PROMPTS[1][1]], [SD_PROMPTS[1][0]]),
                         ([p for _, p in SD_PROMPTS], [s for s, _ in SD_PROMPTS])):
        rec, img, _ = _sd_request(pipe, f"SDXL-Turbo batch {len(texts)} seeds={seeds}", texts, seeds, SDXL_STEPS,
                                  0.0)
        if rec["flash_launches"] != 70 * SDXL_STEPS:
            raise AssertionError(f"SDXL request: {rec['flash_launches']} A launches, want {70 * SDXL_STEPS}")
        total += rec["flash_launches"]
        requests.append(dict(rec, seeds=seeds, images_per_s=len(texts) / rec["latency_s"]))
        images.append(img)
    if torch.equal(images[0], images[1]):
        raise AssertionError("SDXL requests with different seeds gave identical images")
    # img2img on the first image, back in [-1, 1]
    image = images[0][0].float() / 127.5 - 1
    rec, img, _ = _sd_request(pipe, "SDXL-Turbo img2img strength 0.5", [SD_PROMPTS[2][1]], [SD_PROMPTS[2][0]],
                              SDXL_STEPS, 0.0, image=image, strength=0.5)
    if rec["flash_launches"] != 70 or rec["steps"] != 1:
        raise AssertionError(f"SDXL img2img: {rec['flash_launches']} A launches in {rec['steps']} steps, want 70 in 1")
    total += rec["flash_launches"]
    record["sdxl_turbo"] = dict(setup, requests=requests, img2img=rec, profile={
        f"batch {len(texts)}": _sd_profile(pipe, f"SDXL-Turbo batch {len(texts)}", texts, seeds, SDXL_STEPS, 0.0)
        for texts, seeds in (([SD_PROMPTS[0][1]], [SD_PROMPTS[0][0]]),
                             ([p for _, p in SD_PROMPTS], [s for s, _ in SD_PROMPTS]))})
    record["launches"] = {"flash_attention_sd": total}
    del pipe, images
    return record


@contextlib.contextmanager
def _sd_numpy_noise():
    """Every draw of the port's SD sampler is standard-normal noise from
    numpy, by (the generator's seed, its draw index), on the generator's
    device: a card-against-CPU check needs the same noise on both."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.models.sd import sampler

    real, counts, keep = sampler.normal, {}, []

    def draw(generator, shape, dtype=torch.float32):
        i = counts.get(id(generator), 0)
        counts[id(generator)] = i + 1
        keep.append(generator)
        arr = np.random.default_rng([generator.initial_seed(), i]).standard_normal(tuple(shape))
        return torch.from_numpy(arr.astype(np.float32)).to(generator.device, dtype)

    sampler.normal = draw
    try:
        yield
    finally:
        sampler.normal = real


class _SmallTokens:
    """Rows of small ids for the small configs' 64-entry CLIP vocabulary,
    EOS 63 (the largest id, where CLIP pools)."""

    eos_token = 63

    def tokenize(self, text):
        return [1] + [3 + sum(map(ord, w)) % 57 for w in text.split()] + [63]


def phase_small_sd():
    """A small SD and a small SDXL config (heads of 64, a 256-token
    self-attention at level 0: 3 and 6 A calls a UNet call) on the card in
    bf16 with kernel A, against the CPU in f32 with its plain version, from
    the same weights, tokens and noise: SD two prompts under CFG (4 steps,
    Euler), SDXL two prompts without CFG (2 ancestral steps), latents and
    images."""
    import torch

    from flux_generator_tpu_torch.models.clip.text import init_clip_text, tiny_clip_config
    from flux_generator_tpu_torch.models.sd.config import UNetConfig, tiny_sd_ae_config
    from flux_generator_tpu_torch.models.sd.unet import init_unet
    from flux_generator_tpu_torch.models.sd.vae import init_sd_vae
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL

    unet = dict(block_out_channels=(64, 128), layers_per_block=(1, 1), num_attention_heads=(1, 2),
                cross_attention_dim=(64, 64), norm_num_groups=32,
                down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"))
    cases = (
        ("sd", StableDiffusion, UNetConfig(transformer_layers_per_block=(1, 1), **unet),
         [tiny_clip_config(model_dims=64)], 4, 4.0, 3),
        ("sdxl", StableDiffusionXL,
         UNetConfig(transformer_layers_per_block=(2, 1), addition_embed_type="text_time", addition_time_embed_dim=8,
                    projection_class_embeddings_input_dim=32 + 6 * 8, **unet),
         [tiny_clip_config(model_dims=32), tiny_clip_config(model_dims=32, projection_dim=32)], 2, 0.0, 6),
    )
    tok = _SmallTokens()
    out = {}
    for tag, cls, unet_cfg, clip_cfgs, steps, cfg, per_call in cases:
        ae_cfg = tiny_sd_ae_config(block_out_channels=(32, 64), norm_num_groups=32)
        g = torch.Generator().manual_seed(7)
        params = {"unet": init_unet(g, unet_cfg), "vae": init_sd_vae(g, ae_cfg),
                  "clip": init_clip_text(g, clip_cfgs[0])}
        if len(clip_cfgs) > 1:
            params["clip_2"] = init_clip_text(g, clip_cfgs[1])
        pipes = {"cpu": cls(tag, params, unet_cfg, ae_cfg, clip_cfgs, tokenizers=[tok, tok], dtype=torch.float32),
                 "gpu": cls(tag, _to_device(params, "cuda", torch.bfloat16), unet_cfg, ae_cfg, clip_cfgs,
                            tokenizers=[tok, tok], dtype=torch.bfloat16)}
        res = {}
        for name, pipe in pipes.items():
            fa0 = fa.launches
            with _sd_numpy_noise():
                lat = list(pipe.generate_latents_batch(["a red fox", "a small boat"], [3, 4], num_steps=steps,
                                                       cfg_weight=cfg, latent_size=(16, 16)))[-1]
            res[name] = (lat.float().cpu(), pipe.decode(lat).float().cpu(), fa.launches - fa0)
        lat_err, img_err = _rel(res["gpu"][0], res["cpu"][0]), _rel(res["gpu"][1], res["cpu"][1])
        launches = res["gpu"][2]
        log(f"[small-sd] {tag}: latent rel-L2 {lat_err:.3e}, image rel-L2 {img_err:.3e} (tol {SMALL_REL_TOL}) | "
            f"A launches on the card {launches} ({steps} steps, {per_call} a UNet call), on the CPU "
            f"{res['cpu'][2]}")
        if launches != per_call * steps or res["cpu"][2] != 0:
            raise AssertionError(f"small {tag}: A launches {launches} on the card, want {per_call * steps}")
        if not (lat_err <= SMALL_REL_TOL and img_err <= SMALL_REL_TOL):
            raise AssertionError(f"small {tag}: the card's run disagrees with the CPU reference")
        out[tag] = dict(latent_rel_l2=lat_err, image_rel_l2=img_err, launches=launches)
    return out


def phase_kernels_sd_long():
    """Kernel A's bf16 mode at head dim 64 without RoPE at the lengths the
    server admits past 512²: SD 2.1's first UNet level under CFG (B 2, H 5)
    at 640² (L 6400) and 1024² (L 16384), held to its plain version run a
    head at a time (its f32 scores are 1.07 GB a head at L 16384), with the
    dropped-keys control; the kernel, the route and the plain version
    timed, the route in turns with SDPA's forward."""
    import torch

    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa

    def plain(q, k, v, cos=None, sin=None):
        return fa.flash_attention_reference(q.float(), k.float(), v.float())

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4322)
    rows = []
    for label, b, length, h, per_request in SD_ATTN_LONG_SHAPES:
        q, k, v = (torch.randn((b, length, h, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        merges = fa.d64_merges(dev)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        geo = _d64_geometry(fa, b, length, h)
        split_note = _d64_split_note(geo, fa.d64_merges(dev) - merges)
        ref, ref_lse = _plain_by_heads(plain, q, k, v, None, None, chunk=1)
        rel, out_abs = _rel(out.float(), ref), (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        dropped, _ = _plain_by_heads(plain, q, k[:, :-64], v[:, :-64], None, None, chunk=1)
        control_rel = _rel(dropped, ref)
        del ref, ref_lse, dropped
        ms = time_ms_queued(lambda: fa.flash_attention_sm90(q, k, v))
        route_ms = time_ms_queued(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: _plain_by_heads(plain, q, k, v, None, None, chunk=1), iters=2, warmup=1)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        turns = in_turns({"route": lambda: fa.flash_attention(q, k, v),
                          "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)}, iters=10)
        library_ms = statistics.mean(turns["sdpa"])
        flops = 4 * b * h * length * length * 64
        bound = bound_ms(flops, 4 * q.numel() * 2 + b * h * length * 4)
        row = dict(case=label, b=b, l=length, h=h, max_abs_err=max(out_abs, lse_err), out_rel_l2=rel,
                   out_max_abs_err=out_abs, lse_max_abs_err=lse_err,
                   control_last_64_keys_dropped_out_rel_l2=control_rel, ms=ms, route_ms=route_ms, plain_ms=plain_ms,
                   library_ms=library_ms, turns_ms=turns, bound_ms=bound[0], bound_by=bound[1],
                   tflops=flops / 1e9 / ms, bound_share=bound[0] / ms, launches_a_request=per_request, **geo)
        tol_out, tol_lse = SD_FLASH_TOL
        log(f"[kernels-sd] flash {label} (B {b}, L {length}, H {h}, D 64): out rel-L2 {rel:.3e} (tol {tol_out}) | "
            f"lse max|Δ| {lse_err:.3e} (tol {tol_lse}) | control, last 64 keys dropped: out rel-L2 "
            f"{control_rel:.3e} (must exceed {tol_out}) | {geo['warpgroups']} consumer warpgroups: "
            f"{geo['units']} tiles, {geo['rounds']:.2f} rounds, {split_note} | kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
            f"{100 * row['bound_share']:.1f}% of the bound {bound[0]:.4f} ms, {bound[1]}; exp floor "
            f"{geo['exp_floor_ms']:.4f} ms) | route {route_ms:.4f} ms | "
            f"plain (a head at a time) {plain_ms:.3f} ms | in turns: route "
            f"{' '.join(f'{t:.4f}' for t in turns['route'])}, SDPA fwd {' '.join(f'{t:.4f}' for t in turns['sdpa'])} "
            f"ms | {per_request} a request at this level (750 A calls a request in all)")
        if not (rel <= tol_out and lse_err <= tol_lse):
            raise AssertionError(f"flash {label} disagrees with its plain version: out rel-L2 {rel}, lse {lse_err}")
        if not control_rel > tol_out:
            raise AssertionError(f"flash {label}: the control with 64 keys dropped passes ({control_rel})")
        rows.append(row)
        del q, k, v, qs, ks, vs, out, lse
        torch.cuda.empty_cache()
    return {"flash_attention_sd_long": rows}


# ------------------------------------------------------------ the served path


def _counts():
    """Every kernel counter of the served paths (A, its RoPE pre-pass and
    int8 tiers, B, C, D, G, H)."""
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    out = _launch_counts()
    out.update(flash_attention_rope=fa.rope_launches, decode_step=ds.launches, lstm=lk.launches)
    return out


def _zero_counts():
    from flux_generator_tpu_torch.ops.kernels import decode_step as ds
    from flux_generator_tpu_torch.ops.kernels import lstm as lk

    _reset_launch_counts()
    ds.launches = ds.e4m3_launches = lk.launches = 0


class _Served:
    """HTTP calls to a running Server: JSON in, (status, JSON, wall s) out."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def call(self, path: str, payload=None):
        import urllib.error
        import urllib.request

        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.base + path, data, {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read()), time.perf_counter() - t0
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), time.perf_counter() - t0

    def ok(self, path: str, payload=None):
        status, body, wall = self.call(path, payload)
        if status != 200:
            raise AssertionError(f"{path} {payload}: HTTP {status} {body}")
        return body, wall

    def concurrent(self, api, path: str, payloads):
        """Send every payload at once while the generation lock is held, so
        that all of them wait as one group, then let them run → ([(body,
        wall)] in payload order, the device's peak above resident GiB)."""
        import threading

        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = [None] * len(payloads)

        def fire(i):
            out[i] = self.ok(path, payloads[i])

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(payloads))]
        api._gen_lock.acquire()
        try:
            for t in threads:
                t.start()
            for _ in range(600):
                with api._batch_lock:
                    pending = sum(len(v) for v in api._pending.values())
                if pending == len(payloads):
                    break
                time.sleep(0.05)
            else:
                raise AssertionError(f"only {pending} of {len(payloads)} requests queued")
        finally:
            api._gen_lock.release()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - resident) / 2**30


def _wav_bytes(data_url: str) -> bytes:
    import base64

    return base64.b64decode(data_url.split(",", 1)[1])


def _wav_frames(raw: bytes):
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(raw), "rb") as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _serve_factories(built: dict, quantized: bool = False):
    """Flux, SD and MusicGen factories for get_app that build full-width
    pipelines on seeded random weights in bf16 on the card (each model once,
    kept in `built`), with the tokenizer assets. `quantized`: the loaders'
    int8 policy, applied on the card to the pipelines in `built` (Flux: flow
    and T5 int8 per channel; SD: the UNet's and first CLIP's denses that
    `_sd_quant_predicate` accepts; MusicGen: decoder and T5)."""
    import torch

    from flux_generator_tpu_torch.io.loaders import _sd_quant_predicate
    from flux_generator_tpu_torch.io.tokenizers import load_t5_tokenizer
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
    from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
    from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL

    dev = torch.device("cuda")

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    def timed(key, make):
        if key not in built:
            t0 = time.perf_counter()
            built[key] = make()
            torch.cuda.synchronize()
            log(f"[main-serve] built {key} in {time.perf_counter() - t0:.2f} s (random weights, seed 0)")
        pipe = built[key]
        if quantized and not getattr(pipe, "_quantized", False):
            t0 = time.perf_counter()
            if key.startswith("flux"):
                pipe.params["flow"] = quantize_tree(pipe.params["flow"])
                pipe.params["t5"] = quantize_tree(pipe.params["t5"])
            elif key == "musicgen":
                pipe.params, pipe.t5_params = quantize_tree(pipe.params), quantize_tree(pipe.t5_params)
            else:
                pipe.params["unet"] = quantize_tree(pipe.params["unet"], _sd_quant_predicate)
                pipe.params["clip"] = quantize_tree(pipe.params["clip"], _sd_quant_predicate)
            pipe._quantized = True
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            log(f"[main-serve-int8] quantized {key} on the card in {time.perf_counter() - t0:.2f} s")
        return pipe

    def flux(name):
        def make():
            pipe = FluxPipeline.random_init(name, dtype=torch.bfloat16, device=dev, generator=seeded())
            pipe.t5_tokenizer, pipe.clip_tokenizer, _ = _tokenizers()
            return pipe
        return timed(name, make)

    def sd(name):
        def make():
            cls = StableDiffusionXL if "xl" in name else StableDiffusion
            pipe = cls.random_init(name, dtype=torch.bfloat16, device=dev, generator=seeded())
            pipe.tokenizers = [_sd_tokenizer()] * len(pipe.clip_cfgs)
            return pipe
        return timed(name, make)

    def music():
        def make():
            pipe = MusicGenPipeline.random_init(tiny=False, dtype=torch.bfloat16, device=dev, generator=seeded())
            pipe.tokenizer = load_t5_tokenizer(ROOT / "tests/assets/spiece/t5_like.model")
            return pipe
        return timed("musicgen", make)

    return flux, sd, music


def _start_server(api):
    from flux_generator_tpu_torch.server.httpd import Server

    srv = Server(api, "127.0.0.1", 0)  # a free port
    srv.start_background()
    return srv, _Served(srv.port)


def _served_vs_direct(tag: str, served: _Served, path: str, payload, direct, key: str):
    """One solo request over HTTP and the same pipeline's direct call with
    the same seed: the answer's `key` (a data URL) equal byte for byte, and
    the kernel launches of each equal. `direct()` returns the data URL; its
    wall time is the call's, ended by a synchronize. → record."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    _zero_counts()
    body, wall = served.ok(path, payload)
    torch.cuda.synchronize()
    served_counts, peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
    got = body[key][0] if isinstance(body[key], list) else body[key]
    _zero_counts()
    t0 = time.perf_counter()
    want = direct()
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t0
    direct_counts = _counts()
    rec = dict(wall_s=wall, direct_s=direct_wall, overhead_ms=1e3 * (wall - direct_wall),
               launches={k: v for k, v in served_counts.items() if v}, resident_gib=resident, peak_gib=peak,
               transient_gib=peak - resident, equal=got == want, bytes=len(got))
    log(f"[main-serve] {tag}: served {wall:.4f} s, direct call {direct_wall:.4f} s, server overhead "
        f"{rec['overhead_ms']:.1f} ms | answer {len(got)} chars, equal to the direct call's: {rec['equal']} | "
        f"launches {rec['launches']} | resident {resident:.2f} GiB, peak {peak:.2f} GiB (+{peak - resident:.2f})")
    if got != want:
        raise AssertionError(f"{tag}: the served answer differs from the direct call's")
    if served_counts != direct_counts:
        raise AssertionError(f"{tag}: launches served {served_counts} != direct {direct_counts}")
    return rec, body


def _image_url(pipe, x, latent_size=None):
    from flux_generator_tpu_torch.server.api import _fetch_u8, _png_data_url

    return _png_data_url(_fetch_u8(pipe, x, latent_size)[0])


def _last(gen):
    x = None
    for x in gen:
        pass
    return x


def _poll_progress(served: _Served, stop, seen: list):
    while not stop.is_set():
        _, snap, _ = served.call("/sdapi/v1/progress")
        seen.append((snap["progress"], snap["textinfo"], snap["current_image"] is not None))
        time.sleep(0.1)


def phase_main_serve():
    """The port's server (server/app.get_app + server/httpd.Server) on
    127.0.0.1 with full-width bf16 pipelines on random weights (the 80 GB
    card's plan), driven over HTTP: each solo request equal byte for byte to
    the same pipeline's direct call, with the same A, C and D launches;
    concurrent groups coalesced; progress previews; 422 and 429. Returns
    (record, the pipelines built, for main-serve-int8)."""
    import io
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from flux_generator_tpu_torch.server import memory
    from flux_generator_tpu_torch.server.app import get_app
    from flux_generator_tpu_torch.utils.audio import save_audio

    built = {}
    flux_f, sd_f, music_f = _serve_factories(built)
    api = get_app(flux_f, sd_f)
    api._music_factory = music_f
    plans = {}
    for slot, model in (("flux", "flux-schnell"), ("sd", "stabilityai/stable-diffusion-2-1-base"),
                        ("sd", "stabilityai/sdxl-turbo"), ("musicgen", "musicgen")):
        plan = memory.MemoryPlanner().plan(slot, model)
        plans[model] = dict(policy=plan.policy, evict=plan.evict, est_gb=plan.est_gb)
    log(f"[main-serve] the planner on this card ({api.memory.budget_gb:.2f} GB, transient "
        f"{api.memory.transient_gb} GB): {plans}")
    if any(p["policy"] != "bf16" or p["evict"] for p in plans.values()):
        raise AssertionError(f"the planner does not keep every family at bf16 on this card: {plans}")
    groups = []
    real_music = api._run_music_batch

    def music_batch(items, *args):
        groups.append(len(items))
        return real_music(items, *args)

    api._run_music_batch = music_batch
    srv, served = _start_server(api)
    rec = dict(plans=plans, budget_gb=api.memory.budget_gb)
    try:
        # ---- Flux-schnell, the schema's defaults: 512², 2 steps, generate_images_fused
        flux_prompt = PROMPTS[0][1]
        body, wall = served.ok("/sdapi/v1/txt2img", {"prompt": "warm-up", "model": "flux-schnell", "seed": 0})
        log(f"[main-serve] Flux warm-up (load + first request, not counted) {wall:.3f} s")
        pipe = api.pipeline
        rec["flux"], _ = _served_vs_direct(
            "Flux-schnell 512², 2 steps", served, "/sdapi/v1/txt2img",
            {"prompt": flux_prompt, "model": "flux-schnell", "seed": 1}, lambda: _image_url_u8(
                pipe.generate_images_fused(flux_prompt, num_steps=2, guidance=4.0, latent_size=(64, 64), seed=1)),
            "images")
        _zero_counts()
        t0 = time.perf_counter()
        res, transient = served.concurrent(api, "/sdapi/v1/txt2img", [
            {"prompt": p, "model": "flux-schnell", "seed": s} for s, p in PROMPTS + [(4, "a red kite")]])
        rec["flux_coalesced"] = dict(wall_s=time.perf_counter() - t0, infos=[b["info"] for b, _ in res],
                                     transient_gib=transient,
                                     launches={k: v for k, v in _counts().items() if v})
        log(f"[main-serve] Flux, 4 at once: {rec['flux_coalesced']['wall_s']:.4f} s | {res[0][0]['info']} | "
            f"launches {rec['flux_coalesced']['launches']} | peak above resident {transient:.2f} GiB")
        if not all("coalesced batch 4" in b["info"] for b, _ in res) or len({b["images"][0] for b, _ in res}) != 4:
            raise AssertionError(f"Flux requests did not coalesce into one batch of 4: {rec['flux_coalesced']}")

        # ---- SD 2.1-base, 50 steps, cfg 4.0, with progress polled
        sd_prompt = SD_PROMPTS[0][1]
        _, wall = served.ok("/sdapi/v1/txt2img", {"prompt": "warm-up", "model": "stabilityai/stable-diffusion-2-1-base",
                                                   "steps": 2, "seed": 0})
        log(f"[main-serve] SD 2.1 warm-up (load + 2 steps, not counted) {wall:.3f} s")
        pipe = api.sd_pipeline
        stop, seen = threading.Event(), []
        poller = threading.Thread(target=_poll_progress, args=(served, stop, seen))
        poller.start()
        try:
            rec["sd21"], _ = _served_vs_direct(
                "SD 2.1-base 512², 50 steps, cfg 4.0", served, "/sdapi/v1/txt2img",
                {"prompt": sd_prompt, "model": "stabilityai/stable-diffusion-2-1-base", "seed": 21},
                lambda: _image_url(pipe, _last(pipe.generate_latents_batch(
                    [sd_prompt], [21], num_steps=50, cfg_weight=4.0, negative_text="", latent_size=(64, 64)))),
                "images")
        finally:
            stop.set()
            poller.join()
        steps_seen = [int(t.split()[1].split("/")[0]) for _, t, _ in seen if t.startswith("Step")]
        rec["sd21"]["progress"] = dict(polls=len(seen), previews=sum(1 for *_, p in seen if p),
                                       steps_seen=sorted(set(steps_seen)))
        log(f"[main-serve] progress during the SD 2.1 request: {len(seen)} polls, "
            f"{rec['sd21']['progress']['previews']} with a preview, steps seen {rec['sd21']['progress']['steps_seen']}")
        if not rec["sd21"]["progress"]["previews"] or len(set(steps_seen)) < 2:
            raise AssertionError(f"progress showed no preview or no rising step count: {rec['sd21']['progress']}")
        if rec["sd21"]["launches"].get("flash_attention") != 750:
            raise AssertionError(f"SD 2.1 request: A launches {rec['sd21']['launches']}, want 750")

        # ---- SDXL-Turbo: solo, 4 at once, img2img at strength 0.5
        xl_prompt = SD_PROMPTS[1][1]
        _, wall = served.ok("/sdapi/v1/txt2img", {"prompt": "warm-up", "model": "stabilityai/sdxl-turbo", "seed": 0})
        log(f"[main-serve] SDXL-Turbo warm-up (load, not counted) {wall:.3f} s")
        pipe = api.sd_pipeline
        rec["sdxl"], body = _served_vs_direct(
            "SDXL-Turbo 512², 2 steps", served, "/sdapi/v1/txt2img",
            {"prompt": xl_prompt, "model": "stabilityai/sdxl-turbo", "seed": 22},
            lambda: _image_url(pipe, _last(pipe.generate_latents_batch(
                [xl_prompt], [22], num_steps=2, cfg_weight=0.0, negative_text="", latent_size=(64, 64)))),
            "images")
        init_image = body["images"][0]
        _zero_counts()
        t0 = time.perf_counter()
        res, transient = served.concurrent(api, "/sdapi/v1/txt2img", [
            {"prompt": p, "model": "stabilityai/sdxl-turbo", "seed": s} for s, p in SD_PROMPTS])
        rec["sdxl_coalesced"] = dict(wall_s=time.perf_counter() - t0, infos=[b["info"] for b, _ in res],
                                     transient_gib=transient,
                                     launches={k: v for k, v in _counts().items() if v})
        log(f"[main-serve] SDXL-Turbo, 4 at once: {rec['sdxl_coalesced']['wall_s']:.4f} s | {res[0][0]['info']} | "
            f"launches {rec['sdxl_coalesced']['launches']} | peak above resident {transient:.2f} GiB")
        if not all("coalesced batch 4" in b["info"] for b, _ in res) or rec["sdxl_coalesced"]["launches"].get(
                "flash_attention") != 140:
            raise AssertionError(f"SDXL requests did not coalesce into one batch of 4: {rec['sdxl_coalesced']}")

        def direct_img2img():
            import base64

            img = Image.open(io.BytesIO(base64.b64decode(init_image.split(",", 1)[1]))).convert("RGB")
            arr = torch.from_numpy(np.array(img.resize((512, 512)))).float() / 255 * 2 - 1
            return _image_url(pipe, _last(pipe.generate_latents_from_image(
                arr, SD_PROMPTS[2][1], n_images=1, strength=0.5, num_steps=2, cfg_weight=0.0, negative_text="",
                seed=23)))

        rec["sdxl_img2img"], _ = _served_vs_direct(
            "SDXL-Turbo img2img, strength 0.5", served, "/sdapi/v1/img2img",
            {"prompt": SD_PROMPTS[2][1], "model": "stabilityai/sdxl-turbo", "init_images": [init_image],
             "denoising_strength": 0.5, "cfg_scale": 0.0, "seed": 23}, direct_img2img, "images")

        # ---- MusicGen-medium: 500 steps solo, then 4 at once
        _, wall = served.ok("/api/music", {"prompt": "warm-up", "max_steps": 8, "seed": 0})
        log(f"[main-serve] MusicGen warm-up (load + 8 steps, not counted) {wall:.3f} s")
        pipe = api.music_pipeline
        mg_prompt = MG_PROMPTS[0][1]

        def direct_music():
            import base64

            wav = pipe.generate_requests([{"text": mg_prompt, "max_steps": MG_STEPS, "seed": 11}], top_k=MG_TOP_K,
                                         temp=1.0, guidance_coef=3.0)[0]
            buf = io.BytesIO()
            save_audio(buf, wav.float().cpu().numpy(), pipe.sampling_rate)
            return "data:audio/wav;base64," + base64.b64encode(buf.getvalue()).decode()

        groups.clear()
        rec["music"], body = _served_vs_direct("MusicGen-medium, 500 steps", served, "/api/music",
                                               {"prompt": mg_prompt, "max_steps": MG_STEPS, "seed": 11},
                                               direct_music, "audio")
        sr, frames = _wav_frames(_wav_bytes(body["audio"]))
        rec["music"].update(sampling_rate=sr, frames=len(frames), duration_s=body["duration_s"])
        if rec["music"]["launches"].get("decode_step") != MG_STEPS or rec["music"]["launches"].get("lstm") != 2:
            raise AssertionError(f"music request: launches {rec['music']['launches']}, want {MG_STEPS} D and 2 C")
        groups.clear()
        _zero_counts()
        t0 = time.perf_counter()
        res, transient = served.concurrent(api, "/api/music", [{"prompt": t, "max_steps": MG_STEPS, "seed": 30 + i}
                                                               for i, t in enumerate(SERVE_TEXTS)])
        rec["music_coalesced"] = dict(wall_s=time.perf_counter() - t0, groups=list(groups), transient_gib=transient,
                                      launches={k: v for k, v in _counts().items() if v},
                                      frames=[len(_wav_frames(_wav_bytes(b["audio"]))[1]) for b, _ in res])
        log(f"[main-serve] MusicGen, 4 at once: {rec['music_coalesced']['wall_s']:.4f} s | groups {groups} | "
            f"launches {rec['music_coalesced']['launches']} | frames {rec['music_coalesced']['frames']} | peak "
            f"above resident {transient:.2f} GiB")
        if groups != [4] or rec["music_coalesced"]["launches"].get("decode_step") != MG_STEPS:
            raise AssertionError(f"music requests did not coalesce into one batch of 4: {rec['music_coalesced']}")

        # ---- refusals
        status, detail, _ = served.call("/sdapi/v1/txt2img", {"prompt": "x", "width": 4096, "model": "flux-schnell"})
        status_missing, _, _ = served.call("/sdapi/v1/txt2img", {"width": 512})
        for _ in range(8):  # every queue slot taken
            api._queue_slots.acquire(blocking=False)
        try:
            status_full, detail_full, _ = served.call("/sdapi/v1/txt2img", {"prompt": "x", "model": "flux-schnell"})
        finally:
            for _ in range(8):
                api._queue_slots.release()
        rec["refusals"] = dict(oversize=status, missing_prompt=status_missing, queue_full=status_full)
        log(f"[main-serve] refusals: 4096 px wide {status} ({detail['detail']}), no prompt {status_missing}, "
            f"queue full {status_full} ({detail_full['detail']})")
        if (status, status_missing, status_full) != (422, 422, 429):
            raise AssertionError(f"refusals {rec['refusals']}, want 422, 422, 429")
    finally:
        srv.shutdown()
    est = memory.footprints_gb()
    rec["resident"] = {slot: dict(model=s.model, policy=s.policy, measured_gb=s.gb,
                                  estimate_gb=est[(s.family, s.policy)]) for slot, s in api.memory.slots.items()}
    for slot, r in rec["resident"].items():
        log(f"[main-serve] slot {slot}: {r['model']} {r['policy']}, measured {r['measured_gb']:.3f} GB, "
            f"planner's estimate {r['estimate_gb']:.3f} GB")
    rec["transient_gib_max"] = max(r["transient_gib"] for k, r in rec.items()
                                   if isinstance(r, dict) and "transient_gib" in r)
    log(f"[main-serve] the largest peak above resident of a served request: {rec['transient_gib_max']:.2f} GiB "
        f"({rec['transient_gib_max'] * 2**30 / 1e9:.2f} GB; the planner keeps {memory.TRANSIENT_GB} GB)")
    if rec["transient_gib_max"] * 2**30 / 1e9 > memory.TRANSIENT_GB:
        raise AssertionError("a served request needed more head-room than server/memory.TRANSIENT_GB")
    if any(s.policy != "bf16" for s in api.memory.slots.values()):
        raise AssertionError(f"the API loaded below bf16 on this card: {rec['resident']}")
    return rec, built


def _image_url_u8(images):
    from flux_generator_tpu_torch.server.api import _host, _png_data_url

    return _png_data_url(_host(images)[0])


def phase_main_serve_int8(built):
    """A second FluxAPI with quantize=True and the "fused" W8A8 route, its
    factories quantizing main-serve's pipelines on the card as the loaders
    do: one Flux, one SD 2.1 and one music request over HTTP, each with G or
    H launched, finite and of the right shape."""
    import base64
    import io

    import numpy as np
    import torch
    from PIL import Image

    from flux_generator_tpu_torch.server.app import get_app

    flux_f, sd_f, music_f = _serve_factories(built, quantized=True)
    api = get_app(flux_f, sd_f, quantize=True, w8a8="fused")
    api._music_factory = music_f
    srv, served = _start_server(api)
    rec = {}
    # a long prompt: T5's int8 denses take G from 16 rows
    long_prompt = ("a slow cinematic orchestral piece with warm strings, soft brass, a distant choir and "
                   "gentle timpani rolls building to a bright and hopeful major key finale")
    try:
        for tag, path, payload in (
                ("flux", "/sdapi/v1/txt2img", {"prompt": PROMPTS[1][1], "model": "flux-schnell", "seed": 2}),
                ("sd21", "/sdapi/v1/txt2img", {"prompt": SD_PROMPTS[3][1],
                                                "model": "stabilityai/stable-diffusion-2-1-base", "seed": 24}),
                ("music", "/api/music", {"prompt": long_prompt, "max_steps": MG_STEPS, "seed": 12})):
            served.ok(path, dict(payload, **({"max_steps": 8} if tag == "music" else {"steps": 1})))  # load
            _zero_counts()
            body, wall = served.ok(path, payload)
            counts = {k: v for k, v in _counts().items() if v}
            if tag == "music":
                sr, frames = _wav_frames(_wav_bytes(body["audio"]))
                shape, finite = (len(frames),), True  # int16 PCM: finite by construction
                want = ((MG_STEPS - 3) * api.music_pipeline.audio_decoder.cfg.hop_length,)
                out_ok = shape == want
            else:
                img = np.array(Image.open(io.BytesIO(base64.b64decode(body["images"][0].split(",", 1)[1]))))
                shape, out_ok = img.shape, img.shape == (512, 512, 3) and img.dtype == np.uint8
            rec[tag] = dict(wall_s=wall, launches=counts, shape=list(shape))
            g_h = counts.get("w8a8_matmul", 0) + counts.get("w8a8_quantize_rows", 0)
            log(f"[main-serve-int8] {tag}: {wall:.4f} s | launches {counts} | output {tuple(shape)}")
            if not g_h or not out_ok:
                raise AssertionError(f"main-serve-int8 {tag}: G/H launches {g_h}, output {shape}")
        pipe = api.pipeline
        lat = _last(pipe.generate_latents(PROMPTS[1][1], num_steps=2, latent_size=(64, 64), seed=2))
        rec["flux"]["latent_finite"] = bool(torch.isfinite(lat).all())
        if not rec["flux"]["latent_finite"]:
            raise AssertionError("main-serve-int8: the Flux latent is not finite")
    finally:
        srv.shutdown()
    rec["resident"] = {slot: dict(model=s.model, policy=s.policy, measured_gb=s.gb) for slot, s in
                       api.memory.slots.items()}
    log(f"[main-serve-int8] slots {rec['resident']}")
    return rec


def phase_small_serve():
    """A small SD config with every UNet and CLIP dense int8 per channel,
    served with w8a8="fused" and attn_int8="qk", on the card (bf16, kernels
    A int8 and G) against the CPU (f32, their plain versions) from the same
    weights, tokens and noise."""
    import torch

    from flux_generator_tpu_torch.models.clip.text import init_clip_text, tiny_clip_config
    from flux_generator_tpu_torch.models.sd.config import UNetConfig, tiny_sd_ae_config
    from flux_generator_tpu_torch.models.sd.unet import init_unet
    from flux_generator_tpu_torch.models.sd.vae import init_sd_vae
    from flux_generator_tpu_torch.ops.quant import quantize_tree
    from flux_generator_tpu_torch.pipelines.sd import StableDiffusion

    unet_cfg = UNetConfig(block_out_channels=(64, 128), layers_per_block=(1, 1), num_attention_heads=(1, 2),
                          cross_attention_dim=(64, 64), norm_num_groups=32, transformer_layers_per_block=(1, 1),
                          down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                          up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"))
    clip_cfg = tiny_clip_config(model_dims=64)
    ae_cfg = tiny_sd_ae_config(block_out_channels=(32, 64), norm_num_groups=32)
    g = torch.Generator().manual_seed(8)
    params = {"unet": quantize_tree(init_unet(g, unet_cfg), lambda p: p["kernel"].ndim <= 3),
              "vae": init_sd_vae(g, ae_cfg), "clip": quantize_tree(init_clip_text(g, clip_cfg), lambda p: True)}
    tok = _SmallTokens()
    pipes = {"cpu": StableDiffusion("sd", params, unet_cfg, ae_cfg, [clip_cfg], tokenizers=[tok], dtype=torch.float32,
                                    w8a8="fused", attn_int8="qk"),
             "gpu": StableDiffusion("sd", _to_device(params, "cuda", torch.bfloat16), unet_cfg, ae_cfg, [clip_cfg],
                                    tokenizers=[tok], dtype=torch.bfloat16, w8a8="fused", attn_int8="qk")}
    res = {}
    for name, pipe in pipes.items():
        _zero_counts()
        with _sd_numpy_noise():
            lat = _last(pipe.generate_latents_batch(["a red fox", "a small boat"], [3, 4], num_steps=4,
                                                    cfg_weight=4.0, latent_size=(16, 16)))
        res[name] = (lat.float().cpu(), pipe.decode(lat).float().cpu(), {k: v for k, v in _counts().items() if v})
    lat_err, img_err = _rel(res["gpu"][0], res["cpu"][0]), _rel(res["gpu"][1], res["cpu"][1])
    launches = res["gpu"][2]
    log(f"[small-serve] SD, w8a8 fused + attn_int8 qk: latent rel-L2 {lat_err:.3e}, image rel-L2 {img_err:.3e} "
        f"(tol {SMALL_REL_TOL}) | launches on the card {launches}, on the CPU {res['cpu'][2]}")
    if launches.get("flash_attention_int8_qk") != 3 * 4 or not launches.get("w8a8_matmul") or res["cpu"][2]:
        raise AssertionError(f"small-serve: launches {launches} on the card, {res['cpu'][2]} on the CPU")
    if not (lat_err <= SMALL_REL_TOL and img_err <= SMALL_REL_TOL):
        raise AssertionError("small-serve: the card's run disagrees with the CPU reference")
    return dict(latent_rel_l2=lat_err, image_rel_l2=img_err, launches=launches)


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
    kernel H (row quantizer) at every (M, K) a "rows" request quantizes,
    queued and by device time, with its request sums; A's int8 tiers at L
    1280 with RoPE (D 128 and 64), at a padded L 1000 and on peaked logits
    with outlier V: the route, its pre-pass and kernel in turns with A's bf16
    route and SDPA's forward. Each against its plain version on the same
    bf16 inputs (the pre-pass bit for bit against its plain version on the
    CPU). G and its yardsticks take the weights as ops.quant stores them
    (K-contiguous)."""
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

    # H at every activation shape a "rows" request quantizes (G_SHAPES' (M, K),
    # launches summed over the denses that share one), queued behind a sleep
    # and by profiler device time (the geometries it did not choose are
    # timed by scripts/prof_quantize_rows.py)
    h_shapes = {}
    for _, m, k, _, per_request in G_SHAPES:
        h_shapes[(m, k)] = h_shapes.get((m, k), 0) + per_request
    h_cases, h_sums = [], dict(queued=0.0, device=0.0, bound=0.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (m, k), per_request in h_shapes.items():
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q, sx = wm.quantize_rows(x)
        rq, rsx = wm.quantize_rows_reference(x)
        err = max((q.int() - rq.int()).abs().max().item(), (sx - rsx).abs().max().item())
        ms = time_ms_queued(lambda: wm.quantize_rows(x))
        dev_ms = device_ms(lambda: wm.quantize_rows(x))
        plain_ms = time_ms(lambda: wm.quantize_rows_reference(x), iters=5, warmup=1)
        # bf16 read, int8 and f32 scales written; abs, max and a scaled round a value
        bound = bound_ms(3 * m * k, 2 * m * k + m * k + 4 * m)
        for key, v in (("queued", ms), ("device", dev_ms), ("bound", bound[0])):
            h_sums[key] += per_request * v
        geo = wm.quantize_geometry(m, k, sms)._asdict()
        log(f"[kernels-w8a8] H {m}x{k} ({per_request} a rows request; {geo}): max|Δ| {err:.3e} (tol 0: the same "
            f"correctly rounded f32 operations) | kernel {ms:.4f} ms queued, {dev_ms:.4f} ms device time "
            f"({(3 * m * k + 4 * m) / ms / 1e6:.1f} GB/s queued, {100 * bound[0] / ms:.1f}% of its bound) | plain "
            f"{plain_ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]})")
        if err != 0:
            failures.append(f"H {m}x{k}: {err}")
        h_cases.append(dict(case=f"{m}x{k}", launches_per_request=per_request, geometry=geo, max_abs_err=err, ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound[0],
                            bound_by=bound[1], bound_share=bound[0] / ms))
        del x, q, sx, rq, rsx
    log(f"[kernels-w8a8] H request-weighted sums over {sum(h_shapes.values())} launches: queued "
        f"{h_sums['queued']:.2f} ms, device time {h_sums['device']:.2f} ms, bound {h_sums['bound']:.2f} ms "
        f"({100 * h_sums['bound'] / h_sums['queued']:.1f}% of the queued time, "
        f"{100 * h_sums['bound'] / h_sums['device']:.1f}% of the device time)")
    # the kernel's fixed latency: one row, whose bytes take 5 ns
    x1 = torch.randn((1, 3072), generator=g, device=dev).to(torch.bfloat16)
    h_sums["one_row_ms"] = time_ms_queued(lambda: wm.quantize_rows(x1))
    log(f"[kernels-w8a8] H fixed latency (1x3072, queued): {h_sums['one_row_ms']:.4f} ms")
    results["w8a8_quantize_rows"] = h_cases
    results["w8a8_quantize_rows_request_sums_ms"] = h_sums

    # A's int8 tiers: out by rel-L2 and lse by max|Δ| against the tier's plain
    # version, and every control (a function the tier must not be) has to
    # fail the check, or the check could not tell the tier apart. The route
    # (pre-pass + kernel), the pre-pass and the kernel apart, A's bf16 route
    # and SDPA's bf16 forward in turns, queued; the pre-pass bit for bit
    # against its plain version on the CPU
    prepass_cases = []
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
            pre = fa.int8_prepass(q, k_, v, cos, sin, tier)
            pre_ref = fa.int8_prepass_reference(q.cpu(), k_.cpu(), v.cpu(), cos.cpu(), sin.cpu(), tier)
            pre_equal = all(torch.equal(pre[name].cpu(), want) for name, want in pre_ref.items())
            scale = d ** -0.5
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (
                fa._rope_f32(q, cos, sin).to(q.dtype), fa._rope_f32(k_, cos, sin).to(q.dtype), v))
            turns = in_turns({"route": lambda: fa.flash_attention(q, k_, v, cos, sin, int8=tier),
                              "prepass": lambda: fa.int8_prepass(q, k_, v, cos, sin, tier),
                              "kernel": lambda: fa.int8_attention(pre, v, scale, tier),
                              "bf16_route": lambda: fa.flash_attention(q, k_, v, cos, sin),
                              "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
            ms, pre_ms, kernel_ms, bf16_ms, sdpa_ms = (statistics.mean(turns[key]) for key in (
                "route", "prepass", "kernel", "bf16_route", "sdpa"))
            plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k_, v, cos, sin, int8=tier),
                               iters=5, warmup=1)
            pre_plain_ms = time_ms(lambda: fa.int8_prepass_reference(q, k_, v, cos, sin, tier), iters=5, warmup=1)
            half = 2 * length * length * d * h  # one of the two products
            parts = ([(half, PEAK_INT8_OPS), (half, PEAK_BF16_FLOPS)] if tier == "qk"
                     else [(2 * half, PEAK_INT8_OPS)])
            # q, k, v, out bf16, the two tables, lse f32
            bound = bound_ms_parts(parts, 4 * q.numel() * 2 + 2 * cos.numel() * 2 + length * h * 4)
            exp_ms = length * length * h / PEAK_EXP_S * 1e3  # the exponentials' floor, beside the bound
            # the pre-pass: q, k (and v) and the tables read, the int8 tensors and the scales written
            l_pad = fa.padded_length(length)
            pre_bytes = (2 * q.numel() * 2 + 2 * cos.numel() * 2 + 2 * h * l_pad * (d + 4)
                         + (q.numel() * 2 + h * l_pad * d + h * d * 4 if tier == "full" else 0))
            pre_bound = bound_ms(0, pre_bytes)
            log(f"[kernels-w8a8] A-{tier} {label}: out rel-L2 {err_out:.3e} (tol {tol_out}), lse max|Δ| "
                f"{err_lse:.3e} (tol {tol_lse}), max|Δ| {err:.3e} | controls (out rel-L2, lse max|Δ|): "
                + ", ".join(f"{n} {o:.3e} {ls:.3e}" for n, (o, ls) in control_dist.items())
                + f" | pre-pass bit for bit {pre_equal} | in turns: route " + " ".join(f"{t:.4f}" for t in turns["route"])
                + " ms, pre-pass " + " ".join(f"{t:.4f}" for t in turns["prepass"])
                + " ms, kernel " + " ".join(f"{t:.4f}" for t in turns["kernel"])
                + " ms, bf16 route " + " ".join(f"{t:.4f}" for t in turns["bf16_route"])
                + " ms, SDPA bf16 forward " + " ".join(f"{t:.4f}" for t in turns["sdpa"])
                + f" ms | route {ms / bf16_ms:.2f}x the bf16 route | plain {plain_ms:.4f} ms | bound {bound[0]:.4f} "
                f"ms ({bound[1]}; {100 * bound[0] / ms:.1f}% of the route, {100 * bound[0] / kernel_ms:.1f}% of the "
                f"kernel), exp floor {exp_ms:.4f} ms | pre-pass bound {pre_bound[0]:.4f} ms (bytes; "
                f"{100 * pre_bound[0] / pre_ms:.1f}%)")
            if not (err_out <= tol_out and err_lse <= tol_lse):
                failures.append(f"A-{tier} {label}: out rel-L2 {err_out}, lse {err_lse}")
            passed = [n for n, (o, ls) in control_dist.items() if o <= tol_out and ls <= tol_lse]
            if passed:
                failures.append(f"A-{tier} {label}: controls {passed} pass the check")
            if not pre_equal:
                failures.append(f"A-{tier} {label}: the pre-pass differs from its plain version")
            tier_cases.append(dict(case=label, max_abs_err=err, out_rel_l2=err_out, lse_max_abs_err=err_lse,
                                   control_out_rel_l2_lse=control_dist, ms=kernel_ms, route_ms=ms,
                                   prepass_ms=pre_ms, turns_ms=turns, plain_ms=plain_ms, library_ms=None,
                                   sdpa_bf16_ms=sdpa_ms, bf16_route_ms=bf16_ms, bound_ms=bound[0],
                                   bound_by=bound[1], bound_share=bound[0] / ms, exp_floor_ms=exp_ms))
            if tier == "full":  # the pre-pass's row: both of its launches
                prepass_cases.append(dict(case=label, max_abs_err=0.0 if pre_equal else float("inf"), ms=pre_ms,
                                          plain_ms=pre_plain_ms, library_ms=None, bound_ms=pre_bound[0],
                                          bound_by=pre_bound[1]))
            del q, k_, v, out, ref, qs, ks, vs, controls, pre, pre_ref
        results[f"flash_attention_int8_{tier}"] = tier_cases
    results["flash_attention_int8_quant"] = prepass_cases
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
        policies = _train_policies(pipe, args, dataset)
    return dict(init_s=init_s, train_s=total_s, encode_s=trace["encode_s"], micro_step_s=steps,
                losses=trace["losses"], peak_gib=peak, launches=launches,
                launches_per_micro_step=per_step, remat_policies=policies)


def _train_policies(pipe, args, dataset):
    """One optimizer step (grad_accumulate micro-steps, the last with the
    Adam update) of the trained pipeline under each recomputation policy of
    the trainer's --remat-policy, in turns (block, dots, dots, block), each
    from the same LoRA on the same micro-batches and draws: the losses
    ("dots" equal to "block"), the step's time, its peak memory above what
    was resident, and E's and F's launches."""
    import torch

    from flux_generator_tpu_torch.io.params import tree_leaves, tree_map
    from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb
    from flux_generator_tpu_torch.training.dreambooth import build_optimizer, make_train_step
    from flux_generator_tpu_torch.training.lora import extract_lora
    from flux_generator_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda")
    flow = pipe.params["flow"]
    start = extract_lora(flow)
    trainer = Trainer(pipe, dataset, resolution=args.resolution, num_augmentations=args.num_augmentations)
    trainer.encode_dataset()
    batches = trainer.iterate(args.batch_size)
    batches = [next(batches) for _ in range(args.grad_accumulate)]
    guidance = torch.full((args.batch_size,), args.guidance, dtype=pipe.dtype, device=dev)
    blocks = pipe.flow_cfg.depth + pipe.flow_cfg.depth_single_blocks
    runs = {"block": [], "dots": []}
    for policy in ("block", "dots", "dots", "block"):
        lora = tree_map(lambda t: t.detach().clone().requires_grad_(True), start)
        optimizer = build_optimizer(args.learning_rate, args.warmup_steps, args.iterations)
        step_fn = make_train_step(pipe, optimizer, flow, args.grad_accumulate, remat=policy)
        opt, accum = optimizer.init(lora), None
        g = torch.Generator(device=dev).manual_seed(5)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        fb.dq_launches = fb.dkv_launches = 0
        losses = []
        t0 = time.perf_counter()
        for i, (x0, t5f, clipf) in enumerate(batches):
            loss, lora, opt, accum = step_fn(lora, opt, accum, g, x0, t5f, clipf, guidance, is_first=i == 0,
                                             should_step=i == len(batches) - 1)
            losses.append(float(loss))
        torch.cuda.synchronize()
        runs[policy].append(dict(step_s=time.perf_counter() - t0, losses=losses,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30, resident_gib=resident,
                                 launches={"flash_attention_bwd_dq": fb.dq_launches,
                                           "flash_attention_bwd_dkv": fb.dkv_launches},
                                 lora=[t.detach() for t in tree_leaves(lora)]))
        del lora, opt, accum, step_fn
    for policy, rs in runs.items():
        log(f"[main-train] --remat-policy {policy}: optimizer step (4 micro-steps) in turns "
            + " ".join(f"{r['step_s']:.4f}" for r in rs) + " s | peak " + " ".join(f"{r['peak_gib']:.2f}" for r in rs)
            + f" GiB, {rs[0]['peak_gib'] - rs[0]['resident_gib']:.2f} above the resident "
            f"{rs[0]['resident_gib']:.2f} | losses {' '.join(f'{x:.6f}' for x in rs[0]['losses'])} | launches "
            f"{rs[0]['launches']}")
    same_losses = all(r["losses"] == runs["block"][0]["losses"] for r in runs["block"] + runs["dots"])
    lora_diff = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(runs["block"][0]["lora"], runs["dots"][0]["lora"]))
    want = {"flash_attention_bwd_dq": blocks * len(batches), "flash_attention_bwd_dkv": blocks * len(batches)}
    log(f"[main-train] dots against block: losses equal {same_losses}; the LoRA after the step max|Δ| "
        f"{lora_diff:.3e}; E and F launches {runs['dots'][0]['launches']} (want {want})")
    if not same_losses:
        raise AssertionError("--remat-policy dots: the losses differ from block's")
    if any(r["launches"] != want for r in runs["block"] + runs["dots"]):
        raise AssertionError(f"E/F launches under the policies: {[r['launches'] for r in runs['dots']]}, want {want}")
    return {policy: [{k: v for k, v in r.items() if k != "lora"} for r in rs] for policy, rs in runs.items()} | {
        "lora_max_abs_diff": lora_diff}


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
    for key, group in (("flash_fwd_sm90", "A flash forward"), ("flash_fwd_d64", "A flash forward"),
                       ("rope_rotate", "A RoPE pre-pass"),
                       ("attn_int8_kernel", "A int8 flash forward"), ("flash_bwd_dq", "E flash dQ"),
                       ("flash_bwd_dkv", "F flash dK/dV"), ("int4_matmul", "B int4 matmul"),
                       ("w8a8_gemm_sm90", "G W8A8 matmul"), ("quantize_blocks_kernel", "G quantizer pass"),
                       ("quantize_rows_kernel", "H row quantizer"),
                       ("quant_qk_kernel", "A int8 pre-pass"), ("quant_v_kernel", "A int8 pre-pass")):
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


# ------------------------------------------------------------ the CLIs from checkpoints on disk

CLI_PROMPT = "a photo of a cat on the mat"
# The embedding before the RVQ, card (C) against the CPU's plain path: both
# hold C's Wh and xw in bf16 at d 1024, the rest of the codec in f32. Both
# controls (another seed's weights; the LSTM block skipped) must miss a limit.
CODEC_REL_TOL = 1e-3
CODES_MIN_SHARE = 0.99  # codes equal to the CPU's: the argmin's near ties may flip a few
T5_LOGITS_REL_TOL = 1e-4  # t5_decode's cached logits, card against the CPU, both f32 with TF32 off


class _RssPeak:
    """The host's resident set, sampled every 10 ms from /proc/self/statm
    while the block runs: `start` and `peak` in GiB."""

    def __init__(self):
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self.start = self.peak = self._rss()

    def _rss(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 2**30

    def _poll(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _write_cache(tag: str, make) -> dict:
    """make() writes one family's synthetic cache into $HF_HUB_CACHE: its
    seconds, GB on disk and the host's peak RSS meanwhile."""
    import torch

    from flux_generator_tpu_torch.io import synthetic

    hub = os.environ["HF_HUB_CACHE"]
    before = synthetic.cache_bytes(hub)
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        make()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    gb = (synthetic.cache_bytes(hub) - before) / 1e9
    log(f"[main-cli] {tag}: wrote {gb:.3f} GB in {seconds:.2f} s ({gb / seconds:.3f} GB/s), host peak RSS "
        f"{rss.peak:.2f} GiB")
    return dict(write_s=seconds, gb=gb, write_peak_rss_gib=rss.peak)


def _load_timed(tag: str, load):
    """load(), a CLI's own from_pretrained call: its seconds (ended by a
    synchronize), the host's RSS before it and at its peak, and the card's
    memory after it."""
    import torch

    _free()
    torch.cuda.synchronize()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        pipe = load()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rec = dict(load_s=seconds, host_rss_before_gib=rss.start, host_peak_rss_gib=rss.peak,
               resident_gib=torch.cuda.memory_allocated() / 2**30)
    log(f"[main-cli] {tag}: loaded in {seconds:.2f} s | host RSS {rss.start:.2f} GiB before, peak {rss.peak:.2f} GiB "
        f"| on the card {rec['resident_gib']:.2f} GiB")
    return pipe, rec


def _cli_vs_direct(tag: str, module, pipe, argv, out_flag: str, direct, out_name: str, expect: dict) -> dict:
    """module.run(pipe, args) with every launch counter zeroed just before
    and read just after, writing OUT/cli/out_name; then direct(path), the
    same pipeline's direct call with the same seed, writing its file. The
    two files equal byte for byte, and the run's launches equal `expect`
    exactly (every counter not named there 0). The CLI's file is kept."""
    import torch

    out = OUT / "cli" / out_name
    out.parent.mkdir(parents=True, exist_ok=True)
    args = module.build_parser().parse_args(argv + [out_flag, str(out)])
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    module.run(pipe, args)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    counts = {k: v for k, v in _counts().items() if v}
    ref = out.with_name("direct_" + out_name)
    t0 = time.perf_counter()
    direct(ref)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    equal = out.read_bytes() == ref.read_bytes()
    rec = dict(argv=argv, latency_s=latency, direct_s=direct_s, launches=counts, bytes=out.stat().st_size,
               equal=equal)
    ref.unlink()
    log(f"[main-cli] {tag}: run {latency:.4f} s, direct call {direct_s:.4f} s | {rec['bytes']} bytes, equal to the "
        f"direct call's: {equal} | launches {counts} (gate {expect})")
    if not equal:
        raise AssertionError(f"{tag}: the CLI's file differs from the direct call's")
    if counts != expect:
        raise AssertionError(f"{tag}: launches {counts} != {expect}")
    return rec


def _save_grid(path, images):
    from flux_generator_tpu_torch.utils.images import save_image_grid

    save_image_grid(str(path), images, rows=1)


def _sd_direct(pipe, n: int, steps: int, cfg: float, seed: int, image=None):
    """The SD pipelines' direct call, as the CLIs make it: the last latent of
    generate_latents (or of generate_latents_from_image at strength 0.9),
    decoded an image at a time."""
    import numpy as np

    def write(path):
        if image is None:
            steps_ = pipe.generate_latents(CLI_PROMPT, n_images=n, num_steps=steps, cfg_weight=cfg, negative_text="",
                                           seed=seed)
        else:
            steps_ = pipe.generate_latents_from_image(image, CLI_PROMPT, n_images=n, strength=0.9, num_steps=steps,
                                                      cfg_weight=cfg, negative_text="", seed=seed)
        x = None
        for x in steps_:
            pass
        _save_grid(path, np.concatenate([pipe.decode_u8(x[i:i + 1]).cpu().numpy() for i in range(n)]))

    return write


def _cli_flux(rec: dict):
    import numpy as np
    import torch

    from flux_generator_tpu_torch.cli import txt2image
    from flux_generator_tpu_torch.io import registry, synthetic
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    rec["write"] = _write_cache("Flux-schnell cache", lambda: synthetic.make_flux_cache(
        os.environ["HF_HUB_CACHE"], registry.flux_configs("flux-schnell"), dtype=torch.bfloat16, device="cuda",
        hub=True))
    pipe, rec["load"] = _load_timed("Flux-schnell", lambda: FluxPipeline.from_pretrained("flux-schnell"))

    def direct(path):
        _save_grid(path, np.concatenate([
            pipe.generate_images(CLI_PROMPT, n_images=1, num_steps=2, guidance=4.0, latent_size=(64, 64), seed=7 + i,
                                 as_uint8=True).cpu().numpy() for i in range(2)]))

    # 2 images × 2 steps × 57 blocks, each with its RoPE pre-pass
    rec["txt2image"] = _cli_vs_direct("txt2image", txt2image, pipe, [CLI_PROMPT, "--n-images", "2", "--seed", "7"],
                                      "--output", direct, "txt2image.png",
                                      {"flash_attention": 228, "flash_attention_rope": 228})
    (OUT / "cli" / "txt2image.png").unlink()


def _cli_sd(rec: dict):
    import torch

    from flux_generator_tpu_torch.cli import image2image, sd_txt2image
    from flux_generator_tpu_torch.io import registry, synthetic
    from flux_generator_tpu_torch.io.params import tree_leaves

    hub = os.environ["HF_HUB_CACHE"]
    rec["write_sd21"] = _write_cache("SD 2.1-base cache", lambda: synthetic.make_sd_cache(
        hub, configs=registry.sd_configs("stable-diffusion-2-1-base"), dtype=torch.bfloat16, device="cuda", hub=True))
    sd, rec["load_sd21"] = _load_timed("SD 2.1-base", lambda: sd_txt2image.load("sd"))
    # CFG batch 2: 50 steps × 15 self-attentions of L ≥ 256
    rec["sd_txt2image_sd21"] = _cli_vs_direct(
        "sd_txt2image --model sd", sd_txt2image, sd, [CLI_PROMPT, "--model", "sd", "--n_images", "1", "--seed", "7"],
        "--output", _sd_direct(sd, 1, 50, 7.5, 7), "sd21.png", {"flash_attention": 750})
    del sd
    _free()
    rec["write_sdxl"] = _write_cache("SDXL-Turbo cache", lambda: synthetic.make_sd_cache(
        hub, xl=True, configs=registry.sd_configs("sdxl-turbo"), dtype=torch.bfloat16, device="cuda", hub=True))
    xl, rec["load_sdxl"] = _load_timed("SDXL-Turbo", lambda: sd_txt2image.load("sdxl"))
    # 2 steps × 70 self-attentions of L ≥ 256 a UNet call
    rec["sd_txt2image_sdxl"] = _cli_vs_direct(
        "sd_txt2image (SDXL-Turbo)", sd_txt2image, xl, [CLI_PROMPT, "--n_images", "4", "--seed", "7"], "--output",
        _sd_direct(xl, 4, 2, 0.0, 7), "sdxl.png", {"flash_attention": 140})
    (OUT / "cli" / "sdxl.png").unlink()
    # on the SD 2.1 image: int(2 · 0.9) = 1 step
    sd21 = OUT / "cli" / "sd21.png"
    rec["image2image_sdxl"] = _cli_vs_direct(
        "image2image (SDXL-Turbo)", image2image, xl, [str(sd21), CLI_PROMPT, "--n_images", "1", "--seed", "7"],
        "--output", _sd_direct(xl, 1, 2, 0.0, 7, image=image2image.read_image(sd21)), "img2img.png",
        {"flash_attention": 70})
    sd21.unlink()
    (OUT / "cli" / "img2img.png").unlink()
    del xl
    _free()
    xq, rec["load_sdxl_int8"] = _load_timed("SDXL-Turbo, then --quantize", lambda: sd_txt2image.load("sdxl", True))
    rec["int8_tensors"] = {k: sum(t.dtype == torch.int8 for t in tree_leaves(xq.params[k]))
                           for k in ("unet", "clip", "clip_2")}
    log(f"[main-cli] SDXL-Turbo --quantize: int8 weight tensors {rec['int8_tensors']}")
    if not all(rec["int8_tensors"].values()):
        raise AssertionError(f"--quantize left a model without int8 weights: {rec['int8_tensors']}")
    rec["sd_txt2image_sdxl_int8"] = _cli_vs_direct(
        "sd_txt2image --quantize (SDXL-Turbo)", sd_txt2image, xq,
        [CLI_PROMPT, "--n_images", "4", "--seed", "7", "--quantize"], "--output", _sd_direct(xq, 4, 2, 0.0, 7),
        "sdxl_int8.png", {"flash_attention": 140})
    (OUT / "cli" / "sdxl_int8.png").unlink()


def _imported_jax(stderr: str) -> list:
    """Modules of jax or of the JAX package in a `python -X importtime` log."""
    names = [line.rsplit("|", 1)[-1].strip() for line in stderr.splitlines() if line.startswith("import time:")]
    return [n for n in names if n in ("jax", "flux_generator_tpu") or n.startswith(("jax.", "flux_generator_tpu."))]


def _tree_to(tree, device):
    from flux_generator_tpu_torch.io.params import tree_map

    return tree_map(lambda t: t.to(device), tree)


def _t5_cached_logits(params, cfg, tokenizer, tokens):
    """t5_decode's logits on its cached path (as t5_generate decodes), fed
    the start id 0 and then `tokens` one at a time: (len + 1, vocab) f32
    on the CPU."""
    import torch

    from flux_generator_tpu_torch.models.t5.t5 import init_decode_cache, t5_decode, t5_encode

    device = params["wte"].device
    src = torch.tensor([tokenizer.tokenize(CLI_PROMPT, prepend_bos=False, append_eos=True, pad=False)],
                       dtype=torch.long, device=device)
    memory = t5_encode(params, cfg, src)
    cache = init_decode_cache(cfg, 1, len(tokens) + 1, memory.dtype, device)
    out = []
    for tok in [0, *tokens]:
        logits, cache = t5_decode(params, cfg, torch.tensor([[tok]], dtype=torch.long, device=device), memory, cache)
        out.append(logits[0, -1].float().cpu())
    return torch.stack(out)


def _cli_musicgen(rec: dict):
    """MusicGen-medium with its t5-base (a full T5, which t5_generate reads)
    and EnCodec repos: the CLI against the direct call, the CLI as a real
    subprocess, and T5's greedy tokens on the card against the CPU. Returns
    the pipeline and the CLI's 500-step WAV, which main-codec reads."""
    import torch

    from flux_generator_tpu_torch.cli import musicgen_generate, t5_generate
    from flux_generator_tpu_torch.io import registry, synthetic
    from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
    from flux_generator_tpu_torch.utils.audio import save_audio

    hub = os.environ["HF_HUB_CACHE"]
    rec["write"] = _write_cache("MusicGen-medium, t5-base and EnCodec 32 kHz cache", lambda: synthetic.make_musicgen_cache(
        hub, registry.musicgen_configs(), dtype=torch.bfloat16, device="cuda", hub=True))
    pipe, rec["load"] = _load_timed("MusicGen-medium", lambda: MusicGenPipeline.from_pretrained())

    def direct(path):
        save_audio(path, pipe.generate("happy rock", max_steps=500, top_k=250, temp=1.0, guidance_coef=3.0, seed=7),
                   pipe.sampling_rate)

    rec["musicgen_generate"] = _cli_vs_direct("musicgen_generate", musicgen_generate, pipe, ["--seed", "7"],
                                              "--output-path", direct, "musicgen.wav",
                                              {"lstm": 2, "decode_step": 500})

    out = OUT / "cli" / "subprocess.wav"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "flux_generator_tpu_torch.cli.musicgen_generate",
                           "--max-steps", "50", "--seed", "3", "--output-path", str(out)],
                          cwd=ROOT, env=dict(os.environ), capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    samples = _wav_frames(out.read_bytes())[1].size if out.exists() else 0
    imports = sum(1 for line in proc.stderr.splitlines() if line.startswith("import time:"))
    jax_mods = _imported_jax(proc.stderr)
    rec["subprocess"] = dict(returncode=proc.returncode, seconds=seconds, wav_samples=samples,
                             modules_imported=imports, jax_modules=jax_mods, stdout=proc.stdout.strip())
    log(f"[main-cli] python -m flux_generator_tpu_torch.cli.musicgen_generate --max-steps 50: exit "
        f"{proc.returncode} in {seconds:.2f} s, a WAV of {samples} samples | {imports} modules imported, of jax or "
        f"the JAX package: {jax_mods}")
    if proc.returncode != 0 or samples == 0 or jax_mods or imports == 0:
        raise AssertionError(f"the CLI subprocess failed: {proc.stderr[-3000:]}")
    out.unlink()

    t5m, rec["load_t5"] = _load_timed("t5-base (full, f32)", lambda: t5_generate.load("t5-base"))
    args = t5_generate.build_parser().parse_args(["--prompt", CLI_PROMPT, "--max-tokens", "64"])
    _zero_counts()
    t0 = time.perf_counter()
    t5_generate.run(t5m, args)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    counts = {k: v for k, v in _counts().items() if v}
    card = t5_generate.greedy_tokens(t5m.params, t5m.cfg, t5m.tokenizer, CLI_PROMPT, 64)
    cpu_params = _tree_to(t5m.params, "cpu")
    t0 = time.perf_counter()
    cpu = t5_generate.greedy_tokens(cpu_params, t5m.cfg, t5m.tokenizer, CLI_PROMPT, 64)
    cpu_s = time.perf_counter() - t0
    # random weights may settle greedy decoding on one id, so the cached
    # path's logits are held too, fed the CPU's tokens on both sides
    rel = _rel(_t5_cached_logits(t5m.params, t5m.cfg, t5m.tokenizer, cpu),
               _t5_cached_logits(cpu_params, t5m.cfg, t5m.tokenizer, cpu))
    rec["t5_generate"] = dict(latency_s=latency, cpu_s=cpu_s, tokens=len(card), distinct_ids=len(set(card)),
                              equal=card == cpu, logits_rel_l2=rel, launches=counts)
    log(f"[main-cli] t5_generate --max-tokens 64: run {latency:.4f} s | {len(card)} greedy tokens on the card "
        f"({len(set(card))} distinct ids), equal to a CPU f32 run's ({cpu_s:.2f} s): {card == cpu} | cached "
        f"logits over {len(cpu) + 1} steps, rel-L2 {rel:.3e} against the CPU (tol {T5_LOGITS_REL_TOL}) | "
        f"launches {counts}")
    if card != cpu or not rel <= T5_LOGITS_REL_TOL or counts:
        raise AssertionError(f"t5_generate: tokens on the card {card} != on the CPU {cpu}, logits rel-L2 {rel}, "
                             f"or launches {counts}")
    return pipe, OUT / "cli" / "musicgen.wav"


def phase_main_cli():
    """Every CLI from synthetic full-width caches written in the hub layout
    into a temporary directory named by HF_HUB_CACHE, one family at a time,
    each cache deleted before the next; the directory goes even when a step
    fails. Returns (record, the MusicGen pipeline, the CLI's WAV)."""
    hub = tempfile.mkdtemp(prefix="fgt-hub-")
    saved = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = hub
    rec = {"disk_free_gb": shutil.disk_usage(hub).free / 1e9}
    log(f"[main-cli] hub cache in {hub}: {rec['disk_free_gb']:.1f} GB free")
    try:
        for family, run in (("flux", _cli_flux), ("sd", _cli_sd)):
            rec[family] = {}
            run(rec[family])
            _free()
            shutil.rmtree(hub)
            os.makedirs(hub)
        rec["musicgen"] = {}
        pipe, wav = _cli_musicgen(rec["musicgen"])
    finally:
        shutil.rmtree(hub, ignore_errors=True)
        if saved is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved
    return rec, pipe, wav


def phase_main_codec(pipe, wav):
    """EnCodec's encoder at full width on the card (32 kHz, d 1024, 2 LSTM
    layers through C) on the music CLI's 10 s WAV read back with `wave`: C's
    launches; the embedding before the RVQ against the CPU's plain f32 path
    on the same weights (rel-L2); the share of codes equal to the CPU's;
    two controls that must miss those limits, another seed's weights and
    the encoder with its LSTM block skipped; decode of the codes; and
    encode's time with C's share of it, by CUDA events."""
    import numpy as np
    import torch

    from flux_generator_tpu_torch.models.musicgen import encodec as enc
    from flux_generator_tpu_torch.ops.kernels import lstm as lk
    from flux_generator_tpu_torch.runtime.device import make_generator

    rate, pcm = _wav_frames(wav.read_bytes())
    wav.unlink()
    x, mask = enc.preprocess_audio(pcm.astype(np.float32) / 32767)
    codec = pipe.audio_decoder
    xc, mc = x.cuda(), mask.cuda()
    lk.launches = 0
    codes, scales = codec.encode(xc, mc)
    torch.cuda.synchronize()
    launches = lk.launches
    emb = codec.embed(xc)
    cpu_codec = enc.EncodecModel(codec.cfg, _tree_to(codec.params, "cpu"))
    t0 = time.perf_counter()
    cpu_emb = cpu_codec.embed(x)
    cpu_codes = cpu_codec.encode(x, mask)[0]
    cpu_s = time.perf_counter() - t0
    rel = _rel(emb.float().cpu(), cpu_emb)
    share = float((codes.cpu() == cpu_codes).float().mean())
    other = enc.EncodecModel.random_init(codec.cfg, make_generator(xc.device, 1))
    share_other = float((other.encode(xc, mc)[0].cpu() == cpu_codes).float().mean())
    kept = [(p, e) for p, e in zip(codec.params["encoder"], codec._enc_spec) if e[0] != "lstm"]
    emb_no_lstm = enc._run_spec([p for p, _ in kept], [e for _, e in kept], codec.cfg, xc)
    nq = codec.num_quantizers_for_bandwidth(None)
    share_no_lstm = float((enc.rvq_encode(codec.params["quantizer"], emb_no_lstm, nq).cpu() == cpu_codes[0])
                          .float().mean())
    rel_no_lstm = _rel(emb_no_lstm.float().cpu(), cpu_emb)
    decoded = codec.decode(codes, scales, mc)
    finite = bool(torch.isfinite(decoded).all())

    # encode's device time, and C's launches in it, by CUDA events
    spans, launch, reps = [], lk._launch, 5

    def timed_launch(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = launch(*a, **k)
        e.record()
        spans.append((s, e))
        return out

    codec.encode(xc, mc)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    lk._launch = timed_launch
    try:
        start.record()
        for _ in range(reps):
            codec.encode(xc, mc)
        end.record()
        torch.cuda.synchronize()
    finally:
        lk._launch = launch
    encode_ms = start.elapsed_time(end) / reps
    c_ms = sum(s.elapsed_time(e) for s, e in spans) / reps
    rec = dict(rate=rate, samples=int(pcm.size), codes_shape=list(codes.shape), launches={"lstm": launches},
               emb_rel_l2=rel, codes_equal_share=share, control_other_seed_share=share_other,
               lstm_skipped_share=share_no_lstm, lstm_skipped_emb_rel_l2=rel_no_lstm,
               decoded_shape=list(decoded.shape), decoded_finite=finite, encode_ms=encode_ms, c_ms=c_ms,
               c_share=c_ms / encode_ms, cpu_s=cpu_s)
    log(f"[main-codec] {pcm.size} samples at {rate} Hz → codes {list(codes.shape)} | C launches {launches} | "
        f"embedding rel-L2 {rel:.3e} against the CPU's f32 (tol {CODEC_REL_TOL}) | codes equal {share:.4f} "
        f"(at least {CODES_MIN_SHARE}); controls, another seed's weights: {share_other:.4f}; the LSTM block "
        f"skipped: {share_no_lstm:.4f}, rel-L2 {rel_no_lstm:.3e} | decode {list(decoded.shape)}, finite {finite} | "
        f"encode {encode_ms:.3f} ms, C {c_ms:.3f} ms ({100 * c_ms / encode_ms:.1f}%) | the CPU {cpu_s:.2f} s")
    if launches != 2:
        raise AssertionError(f"encode launched C {launches} times, not 2")
    if not rel <= CODEC_REL_TOL or share < CODES_MIN_SHARE:
        raise AssertionError(f"encode: embedding rel-L2 {rel} or code share {share} out of bounds")
    if share_other >= CODES_MIN_SHARE:
        raise AssertionError(f"the other-seed control passed the code check: {share_other}")
    if rel_no_lstm <= CODEC_REL_TOL or share_no_lstm >= CODES_MIN_SHARE:
        raise AssertionError(f"the LSTM-skipped control passed a check: rel-L2 {rel_no_lstm}, "
                             f"code share {share_no_lstm}")
    if not finite or decoded.shape[1] != x.shape[1]:
        raise AssertionError(f"decode of the codes: shape {list(decoded.shape)}, finite {finite}")
    return rec


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
    t_start = time.perf_counter()
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

    seconds = {"device": time.perf_counter() - t_start}  # each phase's wall seconds, in order

    def timed(label, phase):
        t0 = time.perf_counter()
        out = phase()
        seconds[label] = time.perf_counter() - t0
        return out

    def run(label, phase):
        out = timed(label, phase)
        gc.collect()  # each phase's pipeline goes before the next is built
        torch.cuda.empty_cache()
        return out

    build_info = timed("build", phase_build)
    kernels = run("kernels", phase_kernels)
    kernels.update(run("kernels-sd", phase_kernels_sd))
    kernels.update(run("kernels-sd-long", phase_kernels_sd_long))
    kernels.update(run("kernels-musicgen", phase_kernels_musicgen))
    kernels.update(run("kernels-musicgen-f8", phase_kernels_musicgen_f8))
    kernels.update(run("kernels-chain", phase_kernels_chain))
    kernels.update(run("kernels-chain-bisect", lambda: phase_kernels_chain_bisect(kernels["decode_chain"][0])))
    kernels.update(run("kernels-train", phase_kernels_train))
    kernels.update(run("kernels-w8a8", phase_kernels_w8a8))
    kernels.update(run("kernels-bare-dot", phase_kernels_bare_dot))
    streamed = run("kernels-flash-streamed", phase_kernels_flash_streamed)
    kernels.update(flash_attention_streamed=streamed["flash_attention_streamed"])
    kernels.update(run("kernels-parallel", phase_kernels_parallel))
    main_run, pipe, latents = timed("main", phase_main)
    main_w8a8 = run("main-w8a8", lambda: phase_main_w8a8(pipe, latents))
    main_2048, latent_2048 = run("main-2048", lambda: phase_main_2048(pipe))
    main_parallel = run("main-parallel", lambda: phase_main_parallel(pipe, latents, latent_2048))
    del pipe, latents, latent_2048
    main_music, pipe = timed("main-musicgen", phase_main_musicgen)
    main_serve = run("main-musicgen-serve", lambda: phase_main_musicgen_serve(pipe))
    main_long = run("main-musicgen-long", lambda: phase_main_musicgen_long(pipe))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    main_train = run("main-train", phase_main_train)
    main_sd = run("main-sd", phase_main_sd)
    served, built = timed("main-serve", phase_main_serve)
    served_int8 = run("main-serve-int8", lambda: phase_main_serve_int8(built))
    del built
    gc.collect()
    torch.cuda.empty_cache()
    main_cli, pipe, wav = timed("main-cli", phase_main_cli)
    main_codec = run("main-codec", lambda: phase_main_codec(pipe, wav))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    small = run("small", phase_small)
    small_tiled = run("small-tiled", phase_small_tiled)
    small_w8a8 = run("small-w8a8", phase_small_w8a8)
    small_music = run("small-musicgen", phase_small_musicgen)
    small_train = run("small-train", phase_small_train)
    small_sd = run("small-sd", phase_small_sd)
    small_serve = run("small-serve", phase_small_serve)

    entries = []
    for mod, key, main_case, path in (
            (fa, "flash_attention", "L1280_rope", main_run),
            (fa, "flash_attention_rope", "L1280_rope", main_run),
            (im, "int4_matmul", "qkvo_4096x4096_g128", main_run),
            # C: the decoder's 2 a music request and the encoder's 2 an encode call
            (lk, "lstm", "d1024_T497_bf16", dict(launches={"lstm": main_music["launches"]["lstm"]
                                                           + main_codec["launches"]["lstm"]})),
            (ds, "decode_step", "int8_B2_W500_off250", main_music)):
        case = next(c for c in kernels[key] if c["case"] == main_case)
        # A's, its pre-pass's and B's launches on the main path and on the parallel paths
        launches = path["launches"][key] + (main_parallel["launches"][key] if path is main_run else 0)
        entries.append(dict(name=key, route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
                            launches=launches,
                            max_abs_err=max(c["max_abs_err"] for c in kernels[key]),
                            ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                            bound_by=case["bound_by"], library_ms=case["library_ms"]))
        if key == "int4_matmul":
            entries[-1]["bound_share"] = case["bound_share"]
    # A at head dim 64 without RoPE on the SD path: SD 2.1's 64² level; its
    # launches are main-sd's requests'
    case = next(c for c in kernels["flash_attention_sd"] if c["case"] == "sd21_L4096")
    entries.append(dict(name="flash_attention_sd", route="cuda", source=fa.SOURCE, replaces=fa.REPLACES,
                        launches=main_sd["launches"]["flash_attention_sd"],
                        max_abs_err=max(c["max_abs_err"] for c in kernels["flash_attention_sd"]),
                        out_rel_l2=max(c["out_rel_l2"] for c in kernels["flash_attention_sd"]),
                        ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                        bound_by=case["bound_by"], library_ms=case["library_ms"]))
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
            ("flash_attention_int8_full", fa.INT8_SOURCE, fa.REPLACES, "L1280_rope"),
            # the int8 tiers' quantize pre-pass ("full": both launches)
            ("flash_attention_int8_quant", fa.INT8_SOURCE, fa.REPLACES, "L1280_rope")):
        case = next(c for c in kernels[key] if c["case"] == main_case)
        entries.append(dict(name=key, route="cuda", source=source, replaces=replaces,
                            launches=main_w8a8["launches"][key],
                            max_abs_err=max(c["max_abs_err"] for c in kernels[key]),
                            ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                            bound_by=case["bound_by"], library_ms=case["library_ms"]))
        if key in ("w8a8_matmul", "w8a8_quantize_rows"):
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
                  main_w8a8=main_w8a8, main_2048=main_2048, main_parallel=main_parallel,
                  main_musicgen=main_music, main_musicgen_serve=main_serve, main_musicgen_long=main_long,
                  main_train=main_train, main_sd=main_sd, main_serve=served, main_serve_int8=served_int8,
                  main_cli=main_cli, main_codec=main_codec,
                  small=small, small_tiled=small_tiled, small_w8a8=small_w8a8, small_musicgen=small_music,
                  small_train=small_train, small_sd=small_sd, small_serve=small_serve, phase_seconds=seconds)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": entries}))
    seconds["total"] = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": {k: round(v, 1) for k, v in seconds.items()}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
