"""The Flux family: the served engine (`FluxAPI.txt2img`) over a Flux
pipeline drawn from the run's seed, the traced run's ranges around its
layers, and the comparison of the served PNGs with the plain reference.

The weights are the benchmark's own draw from the run's seed
(`benchmark/weights.py`), handed to the pipeline's constructor and, after
the window, to the reference. In the untraced run the pipeline is handed to
the engine bare. The traced run puts a proxy between the engine and the
pipeline that opens a range around each call of the batched path
(`bench.flux.cond` for the conditioning, `bench.flux.step` for each of the
batched generator's steps, `bench.flux.decode`) and counts images per
call, and wraps the pipeline's own `prepare_conditioning`.
"""

from __future__ import annotations

import base64
import io
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.families import constructor_args, plain

ASSETS = Path(__file__).resolve().parents[1] / "assets"

PARTS = ("flow", "ae", "clip", "t5")
FLOW_RANGES = ("bench.flux.step",)
CALL_RANGES = ("bench.flux.cond", "bench.flux.step", "bench.flux.decode")


def _ranged(name, fn):
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


class _Steps:
    """The batched generator, each next() a range: the first the
    conditioning, each later one a step."""

    def __init__(self, gen):
        self.gen, self.first = gen, True

    def __iter__(self):
        return self

    def __next__(self):
        with record_function("bench.flux.cond" if self.first else "bench.flux.step"):
            self.first = False
            return next(self.gen)


class Proxy:
    """Stands for the pipeline in the engine's slot in the traced run."""

    def __init__(self, pipe, calls: list):
        self._pipe, self._calls = pipe, calls

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate_latents_batch(self, texts, seeds, num_steps=2, **kwargs):
        self._calls.append((len(texts), num_steps))
        return _Steps(self._pipe.generate_latents_batch(texts, seeds, num_steps=num_steps, **kwargs))

    def decode_u8(self, *args):
        with record_function("bench.flux.decode"):
            return self._pipe.decode_u8(*args)


class System:
    """One Flux pipeline behind the engine, built by its constructor from
    the configuration file's numbers (checked against the port's registry)
    and the benchmark's draw; with `tiny` the port's small test
    configuration on the CPU."""

    def __init__(self, cfg: dict, seed: int, device, tiny: bool = False):
        from flux_generator_tpu_torch.io.registry import flux_configs
        from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer
        from flux_generator_tpu_torch.models.clip.text import CLIPTextConfig
        from flux_generator_tpu_torch.models.flux.autoencoder import AutoEncoderConfig
        from flux_generator_tpu_torch.models.flux.model import FluxConfig
        from flux_generator_tpu_torch.models.t5.t5 import T5Config
        from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
        from flux_generator_tpu_torch.server.api import FluxAPI

        from benchmark import weights

        dtype = getattr(torch, cfg["dtype"])
        if tiny:
            cfg = dict(cfg, **_tiny_configs())
        else:
            listed = dict(zip(PARTS, (plain(c) for c in flux_configs(cfg["model"]))))
            if any(listed[k] != cfg[k] for k in PARTS):
                raise RuntimeError(f"the port's registry does not list the file's configuration: {listed}")
        self.cfg = cfg
        self.weights = weights.draw(weights.flux(cfg), seed, device, dtype)
        cfgs = [kind(**constructor_args(cfg[k])) for kind, k in
                zip((FluxConfig, AutoEncoderConfig, CLIPTextConfig, T5Config), PARTS)]
        pipe = FluxPipeline(cfg["model"], self.weights, *cfgs, dtype=dtype)
        pipe.t5_tokenizer = load_t5_tokenizer(ASSETS / "spiece" / "t5_like.model", max_length=cfg["t5_max_length"])
        pipe.clip_tokenizer = load_clip_tokenizer(ASSETS / "clip_tokenizer" / "vocab.json",
                                                  ASSETS / "clip_tokenizer" / "merges.txt")
        self.pipe = pipe
        self.api = FluxAPI(pipeline_factory=lambda name: pipe, budget_gb=80.0 if str(device) == "cpu" else None)
        self.calls: list = []

    def pick(self, records, n: int, seed: int):
        """The requests to compare: n drawn from the seed."""
        from benchmark.harness import sample

        return sample(records, n, seed)

    def plan(self) -> str:
        """The weight policy the engine's planner picks for this model here."""
        return self.api.memory.plan("flux", self.cfg["model"]).policy

    def serve(self, req: dict):
        """One txt2img request → (the data URLs, images returned)."""
        from flux_generator_tpu_torch.server.schemas import SDAPIRequest

        body = SDAPIRequest(prompt=req["prompt"], width=req["width"], height=req["height"], steps=req["steps"],
                            batch_size=req["batch_size"], seed=req["seed"], model=self.cfg["model"])
        images = self.api.txt2img(body).images
        return images, len(images)

    def instrument(self):
        pipe = self.pipe
        pipe.prepare_conditioning = _ranged("bench.flux.cond", pipe.prepare_conditioning)
        self.api.pipeline = Proxy(pipe, self.calls)

    def release(self):
        """Drop the engine and the pipeline; the benchmark's draw stays."""
        self.api = self.pipe = None

    def check(self, records, control: bool = False) -> dict:
        """The served images of `records` against the reference's → numbers:
        image_rel_l2, the worst image's ‖served − reference‖ over
        ‖reference − its mean‖ in pixel levels; with `control`, the same of
        the reference computed in fp8 in the program's place."""
        from benchmark.reference import flux as ref
        from benchmark.reference.ops import Precision, no_tf32
        from benchmark.reference.tokenizers import BpeCLIP, UnigramT5

        toks = (UnigramT5(ASSETS / "spiece" / "t5_like.model", self.cfg["t5_max_length"]),
                BpeCLIP(ASSETS / "clip_tokenizer"))
        worst = {"image_rel_l2": 0.0}
        if control:
            worst["control_image_rel_l2"] = 0.0
        with torch.no_grad(), no_tf32():
            for rec in records:
                req = rec.req
                steps = req["steps"] or 2
                want = ref.generate(self.weights, self.cfg, toks, req["prompt"], req["seed"], req["batch_size"],
                                    req["width"], req["height"], steps).cpu().numpy().astype(np.float64)
                got = np.stack([_pixels(u) for u in rec.output]).astype(np.float64)
                worst["image_rel_l2"] = max(worst["image_rel_l2"], _rel(got, want))
                if control:
                    low = ref.generate(self.weights, self.cfg, toks, req["prompt"], req["seed"], req["batch_size"],
                                       req["width"], req["height"], steps, Precision("fp8")).cpu().numpy()
                    worst["control_image_rel_l2"] = max(worst["control_image_rel_l2"],
                                                        _rel(low.astype(np.float64), want))
        return worst


def _tiny_configs() -> dict:
    """The port's small test configuration, its CLIP widened to the test
    tokenizer's 719 ids and 77 positions (CPU tests)."""
    from flux_generator_tpu_torch.models.clip.text import tiny_clip_config
    from flux_generator_tpu_torch.models.flux.autoencoder import tiny_ae_config
    from flux_generator_tpu_torch.models.flux.model import tiny_flux_config
    from flux_generator_tpu_torch.models.t5.t5 import tiny_t5_config

    flow = tiny_flux_config()
    return dict(zip(PARTS, map(plain, (flow, tiny_ae_config(z_channels=flow.in_channels // 4),
                                        tiny_clip_config(model_dims=flow.vec_in_dim, vocab_size=1024,
                                                         max_length=77),
                                        tiny_t5_config(d_model=flow.context_in_dim)))))


def _pixels(data_url: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(io.BytesIO(base64.b64decode(data_url.split(",", 1)[1]))).convert("RGB"))


def _rel(got, want) -> float:
    """max over images of ‖got − want‖ / ‖want − mean(want)‖."""
    if got.shape != want.shape:
        return float("inf")
    out = 0.0
    for g, w in zip(got, want):
        out = max(out, float(np.linalg.norm(g - w) / max(np.linalg.norm(w - w.mean()), 1e-9)))
    return out
