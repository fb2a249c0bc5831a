"""MusicGen text-to-music pipeline (counterpart of
flux_generator_tpu/pipelines/musicgen.py).

T5-encode the prompt, project it into the decoder width, run the
delay-pattern AR loop with CFG and top-k sampling on the device, then decode
the codes to a waveform with EnCodec. The device is the one the params lie
on; sampling noise comes from a `torch.Generator` seeded per request. The
loop runs exactly `max_steps` steps: the JAX package's step-count buckets
serve XLA's compile cache, which eager PyTorch does not have.

`generate_requests` serves several users at once: their requests run in one
batched AR loop, each with its own prompt, duration and seed. `kv_dtype`
("bf16" or "f8") picks the self-attention cache's storage, the JAX
package's FGT_MG_KV. `w8a8` (a route of ops.linear.dense) is the JAX
package's process-wide `set_w8a8(True)`: it reaches T5's and `text_proj`'s
int8 per-channel dense layers and the plain decode step's projections; the
fused step (kernel D) reads its weights itself and is not changed by it.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..io.params import tree_leaves
from ..models.musicgen import model as mg
from ..models.musicgen.encodec import EncodecModel, tiny_encodec_config
from ..models.t5.t5 import T5Config, init_t5_encoder, t5_encode, tiny_t5_config
from ..runtime.device import as_device, make_generator, synchronize
from ..runtime.profiling import span

MIN_STEPS, MAX_STEPS = 8, 2500  # the durations a request may ask for (about 50 s at most)


def _next_pow2_bucket(s: int, floor: int = 16) -> int:
    """The smallest of 16, 32, 64, ... that holds s: coalesced prompts are
    padded to one such length, as in the JAX package."""
    b = floor
    while b < s:
        b *= 2
    return b


class MusicGenPipeline:
    def __init__(self, cfg: mg.MusicGenConfig, params: dict, t5_cfg: T5Config, t5_params: dict,
                 audio_decoder: EncodecModel, tokenizer=None, dtype=torch.float32,
                 kv_dtype: str = "bf16", w8a8: Optional[str] = None):
        mg.kv_cache_dtype(kv_dtype, dtype)  # raises for an unknown kv_dtype
        self.kv_dtype = kv_dtype
        self.w8a8 = w8a8
        self.cfg = cfg
        self.params = params
        self.t5_cfg = t5_cfg
        self.t5_params = t5_params
        self.audio_decoder = audio_decoder
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.sampling_rate = audio_decoder.cfg.sampling_rate

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    @classmethod
    def random_init(cls, tiny: bool = True, dtype=torch.float32, device=None,
                    generator: Optional[torch.Generator] = None, kv_dtype: str = "bf16",
                    w8a8: Optional[str] = None, **cfg_overrides):
        """Randomly initialized pipeline on `device`, drawn from `generator`
        (seed 0 on `device` when None); with neither given, on the current
        CUDA device, raising where there is none. tiny=False draws MusicGen-medium,
        T5-base and EnCodec 32 kHz at their published widths (io/registry.py);
        the decoder and T5 take `dtype`, EnCodec stays f32 as the JAX loader
        keeps it."""
        device = as_device(device if device is not None
                           else (generator.device if generator is not None else None))
        generator = generator if generator is not None else make_generator(device, 0)
        if tiny:
            cfg = mg.tiny_musicgen_config(**cfg_overrides)
            t5_cfg = tiny_t5_config(d_model=cfg.text_d_model)
            # size the bandwidth so the codec builds exactly num_codebooks
            # quantizers (per-quantizer rate = frame_rate · log2(codebook) bps)
            enc_cfg = tiny_encodec_config(codebook_size=cfg.codebook_size)
            bw = cfg.num_codebooks * enc_cfg.frame_rate * enc_cfg.codebook_nbits / 1000
            enc_cfg = tiny_encodec_config(codebook_size=cfg.codebook_size, target_bandwidths=(bw,))
        else:
            from ..io.registry import musicgen_configs

            if cfg_overrides:
                raise ValueError("config overrides apply to tiny=True only")
            cfg, t5_cfg, enc_cfg = musicgen_configs()
        return cls(
            cfg,
            mg.init_musicgen(generator, cfg, dtype, device),
            t5_cfg,
            init_t5_encoder(generator, t5_cfg, dtype, device),
            EncodecModel.random_init(enc_cfg, generator, torch.float32, device),
            dtype=dtype,
            kv_dtype=kv_dtype,
            w8a8=w8a8,
        )

    @classmethod
    def from_pretrained(cls, repo: str = "facebook/musicgen-medium", dtype=torch.bfloat16, quantize: bool = False,
                        device=None, **kwargs):
        """The pipeline of a checkpoint (io/loaders.load_musicgen_pipeline):
        the repo in the local hub cache, or `local_dir=`; on `device` (the
        current CUDA device when None). `quantize` puts the decoder's and
        T5's dense layers in int8."""
        from ..io.loaders import load_musicgen_pipeline

        return load_musicgen_pipeline(repo, dtype=dtype, quantize=quantize, device=device, **kwargs)

    def conditioning(self, text: str) -> torch.Tensor:
        """Prompt → projected T5 features (1, S, hidden) in the pipeline dtype."""
        if self.tokenizer is None:
            raise RuntimeError("pipeline built without a tokenizer")
        device = self.device
        with span("fgt.musicgen.cond", device):
            tokens = torch.tensor(self.tokenizer.encode(text, pad=False), dtype=torch.long, device=device)
            if tokens.dim() == 1:
                tokens = tokens[None]
            feats = t5_encode(self.t5_params, self.t5_cfg, tokens, self.w8a8).to(self.dtype)
            return mg.condition_text(self.params, feats, self.w8a8)

    def _mark(self, trace, key, t0):
        """With a trace, the seconds since t0 under `key`, ended by a device
        synchronize; the clock for the next phase."""
        if trace is not None:
            synchronize(self.device)
            trace[key] = time.perf_counter() - t0
        return time.perf_counter()

    def _step_events(self, trace, step_times):
        """A list for generate's per-step timing events when step times are
        asked for with a trace on the card, else None."""
        return [] if step_times and trace is not None and self.device.type == "cuda" else None

    @staticmethod
    def _step_ms(trace, events):
        if events:
            trace["step_ms"] = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def _codes(self, conditioning, max_steps, top_k, temp, guidance_coef, seed, step_events=None):
        generator = make_generator(conditioning.device, seed)
        return mg.generate(self.params, self.cfg, conditioning, int(max_steps), int(top_k),
                           float(temp), float(guidance_coef), generator, kv_dtype=self.kv_dtype,
                           step_events=step_events, w8a8=self.w8a8)

    def _decode(self, codes):
        """codes (n, K, T) → waveforms (n, T·hop, C)."""
        with span("fgt.musicgen.codec", codes.device):
            return self.audio_decoder.decode(codes[None], [None])

    def generate(self, text: str, max_steps: int = 200, top_k: int = 250, temp: float = 1.0,
                 guidance_coef: float = 3.0, seed: Optional[int] = None, conditioning=None,
                 n_samples: int = 1, trace: Optional[dict] = None, step_times: bool = False):
        """Waveform (T, C) of the first sample; with n_samples > 1 all are
        generated in one batched AR loop (`generate_batch` returns them all).

        `trace`, when a dict is given, receives the seconds of each phase
        ("conditioning_s", "ar_s", "decode_s", each ended by a device
        synchronize) and the codes ("codes"). With `step_times` on the card it
        also receives each AR step's ms on the stream ("step_ms", between CUDA
        events recorded after each step, so any idle gap between steps is
        included)."""
        t0 = time.perf_counter()
        if conditioning is None:
            conditioning = self.conditioning(text)
        if n_samples > 1 and conditioning.shape[0] == 1:
            conditioning = conditioning.expand(n_samples, *conditioning.shape[1:])
        t0 = self._mark(trace, "conditioning_s", t0)
        events = self._step_events(trace, step_times)
        codes = self._codes(conditioning, max_steps, top_k, temp, guidance_coef, seed, events)
        t0 = self._mark(trace, "ar_s", t0)
        audio = self._decode(codes[:1])
        self._mark(trace, "decode_s", t0)
        if trace is not None:
            trace["codes"] = codes
            self._step_ms(trace, events)
        return audio[0]

    def generate_requests(self, requests, top_k: int = 250, temp: float = 1.0,
                          guidance_coef: float = 3.0, trace: Optional[dict] = None,
                          step_times: bool = False):
        """Several users' requests in one batched AR loop (the JAX package's
        `generate_requests`, pipelines/musicgen.py:148-194). requests: dicts
        {"text": str, "max_steps": int, "seed": Optional[int]}. Each prompt
        is conditioned alone and padded to one S bucket, its length masking
        cross-attention (`cond_len`); each duration, clamped to 8..2500
        steps, rides per-sample `live_steps`; each seed gets its own
        generator. The loop runs max(durations) steps; each request's codes
        are cut to its own length and decoded alone, so they equal a solo
        run of that request. (top_k, temp, guidance) are shared: they are the
        key a server coalesces on. Returns the waveforms [(T_i, C)] in
        request order; `trace` and `step_times`, as in `generate` (its
        "codes" a list)."""
        t0 = time.perf_counter()
        n, h = len(requests), self.cfg.hidden_size
        conds = [self.conditioning(r["text"]) for r in requests]  # (1, S_i, H)
        cond = torch.zeros((n, _next_pow2_bucket(max(c.shape[1] for c in conds)), h),
                           dtype=self.dtype, device=self.device)
        for i, c in enumerate(conds):
            cond[i, :c.shape[1]] = c[0]
        cond_len = [c.shape[1] for c in conds]
        steps = [max(MIN_STEPS, min(int(r["max_steps"]), MAX_STEPS)) for r in requests]
        generators = [make_generator(self.device, r.get("seed") or 0) for r in requests]
        t0 = self._mark(trace, "conditioning_s", t0)
        events = self._step_events(trace, step_times)
        codes = mg.generate(self.params, self.cfg, cond, max(steps), int(top_k), float(temp),
                            float(guidance_coef), live_steps=torch.tensor(steps, device=self.device),
                            cond_len=cond_len, generators=generators, kv_dtype=self.kv_dtype,
                            step_events=events, w8a8=self.w8a8)
        t0 = self._mark(trace, "ar_s", t0)
        k = self.cfg.num_codebooks
        codes = [codes[i:i + 1, :, :st - k + 1] for i, st in enumerate(steps)]
        waves = [self._decode(c)[0] for c in codes]
        self._mark(trace, "decode_s", t0)
        if trace is not None:
            trace["codes"] = codes
            self._step_ms(trace, events)
        return waves

    def generate_batch(self, text: str, n_samples: int = 2, **kwargs):
        """All n sample waveforms (n, T, C), generated in one batched AR loop."""
        args = [kwargs.pop(k, d) for k, d in (("max_steps", 200), ("top_k", 250), ("temp", 1.0),
                                             ("guidance_coef", 3.0), ("seed", None))]
        if kwargs:
            raise TypeError(f"unexpected arguments {sorted(kwargs)}")
        conditioning = self.conditioning(text)
        conditioning = conditioning.expand(n_samples, *conditioning.shape[1:])
        return self._decode(self._codes(conditioning, *args))
