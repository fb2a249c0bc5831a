"""The MusicGen family: the served engine (`FluxAPI.generate_music`) over a
MusicGen pipeline drawn from the run's seed, the traced run's range around
each batched call, and the comparison of what was served with the plain
reference.

The weights are the benchmark's own draw from the run's seed
(`benchmark/weights.py`), handed to the pipeline's constructor and, after
the window, to the reference. In every run the pipeline's EnCodec decoder
is wrapped so that the codes of each served sample are kept (a reference
to the tensor the decoder is handed; nothing is computed or copied). The reference is handed those codes,
lays them out in the delay pattern, and judges the program's decoder by
their logits and its codec by the waveform. In the traced run a proxy in the
engine's slot opens `bench.music.call` around each `generate_requests`,
counts samples per call, and passes it a `trace` dict for the AR loop's
seconds.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch.profiler import record_function

from benchmark.families import constructor_args, plain

ASSETS = Path(__file__).resolve().parents[1] / "assets"
PARTS = ("decoder", "t5", "encodec")


class Proxy:
    def __init__(self, pipe, calls: list):
        self._pipe, self._calls = pipe, calls

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate_requests(self, requests, **kwargs):
        trace = {}
        with record_function("bench.music.call"):
            out = self._pipe.generate_requests(requests, trace=trace, **kwargs)
        steps = max(max(8, min(int(r["max_steps"]), 2500)) for r in requests)
        self._calls.append({"samples": len(requests), "steps": steps, "ar_s": trace["ar_s"]})
        return out


class System:
    def __init__(self, cfg: dict, seed: int, device, tiny: bool = False):
        from flux_generator_tpu_torch.io.registry import musicgen_configs
        from flux_generator_tpu_torch.io.tokenizers import load_t5_tokenizer
        from flux_generator_tpu_torch.models.musicgen.encodec import EncodecConfig, EncodecModel
        from flux_generator_tpu_torch.models.musicgen.model import MusicGenConfig
        from flux_generator_tpu_torch.models.t5.t5 import T5Config
        from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
        from flux_generator_tpu_torch.server.api import FluxAPI

        from benchmark import weights

        dtype = getattr(torch, cfg["dtype"])
        if tiny:
            cfg = dict(cfg, **_tiny_configs())
        else:
            listed = dict(zip(PARTS, (plain(c) for c in musicgen_configs())))
            if any(listed[k] != cfg[k] for k in PARTS):
                raise RuntimeError(f"the port's registry does not list the file's configuration: {listed}")
        self.cfg = cfg
        self.weights = {"decoder": weights.draw(weights.musicgen_decoder(cfg["decoder"]), seed, device, dtype, 1),
                        "t5": weights.draw(weights.t5_encoder(cfg["t5"]), seed, device, dtype, 2),
                        "encodec": weights.draw(weights.encodec(cfg["encodec"]), seed, device,
                                                getattr(torch, cfg["encodec_dtype"]), 3)}
        codec = EncodecModel(EncodecConfig(**constructor_args(cfg["encodec"])), self.weights["encodec"])
        pipe = MusicGenPipeline(MusicGenConfig(**cfg["decoder"]), self.weights["decoder"], T5Config(**cfg["t5"]),
                                self.weights["t5"], codec, dtype=dtype, kv_dtype=cfg["kv_dtype"])
        pipe.tokenizer = load_t5_tokenizer(ASSETS / "spiece" / "t5_like.model")
        self.codes: list = []
        decode = pipe.audio_decoder.decode

        def keep(audio_codes, audio_scales, padding_mask=None):
            self.codes.append(audio_codes[0])
            return decode(audio_codes, audio_scales, padding_mask)

        pipe.audio_decoder.decode = keep
        self.pipe = pipe
        self.api = FluxAPI(budget_gb=80.0 if str(device) == "cpu" else None)
        self.api._music_factory = lambda: pipe
        self.calls: list = []

    def pick(self, records, n: int, seed: int):
        """The requests to compare: n greedy and n sampled ones drawn from the
        seed, and the longest."""
        from benchmark.harness import sample

        greedy = sample(records, n, seed, prefer=lambda r: r.req["top_k"] == 1, key=lambda r: r.req["max_steps"])
        sampled = sample(records, n, seed + 1, prefer=lambda r: r.req["top_k"] > 1)
        return greedy + [r for r in sampled if all(r is not g for g in greedy)]

    def plan(self) -> str:
        return self.api.memory.plan("musicgen", "musicgen").policy

    def serve(self, req: dict):
        """One music request → ([(waveform, codes)], audio seconds returned)."""
        del self.codes[:]
        waves, rate = self.api.generate_music(req["prompt"], max_steps=req["max_steps"], top_k=req["top_k"],
                                              temperature=req["temperature"], guidance=req["guidance"],
                                              seed=req["seed"], n_samples=req["n_samples"])
        out = list(zip(waves, list(self.codes)))
        return out, sum(w.shape[0] for w in waves) / rate

    def instrument(self):
        self.api.music_pipeline = Proxy(self.pipe, self.calls)

    def release(self):
        """Drop the engine and the pipeline; the benchmark's draw stays."""
        self.api = self.pipe = None

    def check(self, records, control: bool = False) -> dict:
        """Numbers of `records`, at the live positions (step, codebook) of each
        sample, under the reference's guided logits worked out on the served
        codes: logit_gap, the widest gap by which a greedy request's served
        token lies below the best logit; topk_gap, the widest by which a
        sampled request's served token lies below the top_k-th best (absent
        where no request of that kind was checked); wave_rel_l2, the worst
        sample's ‖served − reference‖ / ‖reference‖ with the reference's
        codec on the served codes. With `control`, the same of the reference
        in the program's place: fp8 for the decoder and T5 (its tokens the
        ones it puts first, or draws from its top_k by the request's
        temperature), bf16 for the f32 codec."""
        from benchmark.reference import musicgen as ref
        from benchmark.reference.ops import Precision, no_tf32
        from benchmark.reference.tokenizers import UnigramT5

        tok = UnigramT5(ASSETS / "spiece" / "t5_like.model")
        dec = self.cfg["decoder"]
        worst: dict = {}

        def note(key, value):
            worst[key] = max(worst.get(key, 0.0), value)

        with torch.no_grad(), no_tf32():
            for rec in records:
                req = rec.req
                steps = max(8, min(int(req["max_steps"]), 2500))
                codes = torch.cat([c for _, c in rec.output]).to(self.weights["decoder"]["emb"].device)
                cond = ref.conditioning(self.weights, self.cfg, tok, req["prompt"])
                seq = ref.delayed(codes, dec, steps)
                live = ref.live_mask(dec, steps, codes.device)
                mixed = ref.guided_logits(self.weights, dec, cond.expand(len(codes), -1, -1), seq, req["guidance"])
                key, top_k = ("logit_gap", 1) if req["top_k"] == 1 else ("topk_gap", int(req["top_k"]))
                note(key, _gap(mixed, seq[:, 1:], live, top_k))
                if control:
                    low_cond = ref.conditioning(self.weights, self.cfg, tok, req["prompt"], Precision("fp8"))
                    low = ref.guided_logits(self.weights, dec, low_cond.expand(len(codes), -1, -1), seq,
                                            req["guidance"], Precision("fp8"))
                    g = torch.Generator(device=low.device).manual_seed(int(req["seed"]))
                    note("control_" + key, _gap(mixed, _draw(low, top_k, req["temperature"], g), live, top_k))
                    del low
                del mixed
                for wave, c in rec.output:
                    want = ref.encodec_decode(self.weights["encodec"], self.cfg["encodec"], c.to(codes.device))[0]
                    note("wave_rel_l2", _rel(wave, want))
                    if control:
                        low = ref.encodec_decode(self.weights["encodec"], self.cfg["encodec"], c.to(codes.device),
                                                 Precision("bf16"))[0]
                        note("control_wave_rel_l2", _rel(low, want))
        return worst


def _tiny_configs() -> dict:
    """The port's small test configuration, its codec's bandwidth sized to
    build exactly the decoder's codebooks (CPU tests)."""
    from flux_generator_tpu_torch.models.musicgen.encodec import tiny_encodec_config
    from flux_generator_tpu_torch.models.musicgen.model import tiny_musicgen_config
    from flux_generator_tpu_torch.models.t5.t5 import tiny_t5_config

    dec = tiny_musicgen_config()
    enc = tiny_encodec_config(codebook_size=dec.codebook_size)
    enc = tiny_encodec_config(codebook_size=dec.codebook_size,
                              target_bandwidths=(dec.num_codebooks * enc.frame_rate * enc.codebook_nbits / 1000,))
    return dict(zip(PARTS, map(plain, (dec, tiny_t5_config(d_model=dec.text_d_model), enc))))


def _gap(logits, tokens, live, top_k: int = 1) -> float:
    """max over live (step, codebook) of the top_k-th best logit − the logit
    of the token, at least 0: logits (n, T, V, K), tokens (n, T, K) long,
    live (T, K)."""
    chosen = logits.gather(2, tokens[:, :, None, :].clamp(max=logits.shape[2] - 1)).squeeze(2)
    cut = logits.topk(top_k, dim=2).values[:, :, -1] if top_k > 1 else logits.amax(dim=2)
    return max(0.0, float((cut - chosen)[:, live].max()))


def _draw(logits, top_k: int, temperature: float, generator):
    """Tokens (n, T, K) drawn as a sampler draws them from logits (n, T, V,
    K): the top_k best, softmax at the temperature; the best where top_k is
    1."""
    if top_k == 1:
        return logits.argmax(dim=2)
    lg = logits.permute(0, 1, 3, 2) / max(float(temperature), 1e-6)
    best = lg.topk(top_k, dim=-1)
    flat = torch.softmax(best.values, dim=-1).reshape(-1, top_k)
    pick = torch.multinomial(flat, 1, generator=generator).reshape(*lg.shape[:-1], 1)
    return best.indices.gather(-1, pick).squeeze(-1)


def _rel(got, want) -> float:
    """‖got − want‖ / ‖want‖ over a waveform (an array or a tensor)."""
    got = torch.as_tensor(got).detach().double().cpu().reshape(-1)
    want = want.double().cpu().reshape(-1)
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).norm() / want.norm().clamp(min=1e-12))
