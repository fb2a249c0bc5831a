"""FluxAPI facade: the backend of the REST API, the web UI and the tests
(the port's copy of flux_generator_tpu/server/api.py, over the port's
pipelines).

Lazy pipeline slots keyed by model name (one Flux, one SD, one MusicGen), the
memory planner's weight policy for each load (server/memory.py), the latent
size, each model's default steps and guidance, base64 PNG data URLs, the
A1111 model / options payloads, a real /sdapi/v1/progress tracker with live
previews, and a generation lock behind a bounded queue (HTTP 429 when full).

Concurrent requests with the same key (model, size, steps, guidance,
negative prompt; for music top_k, temperature and guidance) coalesce: the
request that holds the lock serves the waiting ones in one batch, up to 4
for Flux and music and 8 for SD and SDXL. PyTorch runs eagerly, so a group
runs at its own size: the JAX package pads a group up to a bucket size, and
its music key holds a step bucket, only to reuse compiled XLA programs.

`quantize` puts every load at int8 at least (the JAX package's
FGT_QUANTIZE=1), `w8a8` (a route of ops.linear.dense) is set on every
pipeline the API holds (the JAX package's process-wide set_w8a8), and
`budget_gb` replaces the card's memory in the planner (needed on the CPU).
"""

from __future__ import annotations

import base64
import contextlib
import functools
import io
import threading
import time
from typing import List, Optional, Tuple, Union

import numpy as np

from ..runtime.profiling import current_request, interval, span
from .schemas import SDAPIRequest, SDAPIResponse


MAX_SIDE = 2048  # a larger side is refused with HTTP 422, as in the JAX package


def to_latent_size(size: Tuple[int, int]) -> Tuple[int, int]:
    """(h, w) in pixels → the latent size: each side snapped up to 16 px,
    then / 8."""
    h, w = size
    if max(h, w) > MAX_SIDE:
        raise ValueError(
            f"requested size {w}x{h} exceeds the serving cap of "
            f"{MAX_SIDE}px per side"
        )
    h = ((h + 15) // 16) * 16
    w = ((w + 15) // 16) * 16
    if (h, w) != size:
        print(
            "Warning: The image dimensions need to be divisible by 16px. "
            f"Changing size to {h}x{w}."
        )
    return (h // 8, w // 8)


class QueueFullError(RuntimeError):
    """Raised when the bounded request queue is full → HTTP 429."""


def _request(fn):
    """fn as one request: a `fgt.engine.request` span, with an id of its own
    that the spans it encloses and its coalesced items carry."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span("fgt.engine.request", new_request=True):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def _batch(items):
    """A batch of coalesced items: records each item's wait since it was
    queued (`fgt.engine.admit`) and holds a `fgt.engine.batch` span with the
    ids of the requests it serves."""
    now = time.time_ns()
    for it in items:
        interval("fgt.engine.admit", it["queued"], now, it["request"])
    with span("fgt.engine.batch") as sp:
        if sp is not None:
            sp.attrs["requests"] = sorted({it["request"] for it in items if it["request"] is not None})
        yield


class ProgressTracker:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.job = ""
            self.total_steps = 0
            self.done_steps = 0
            self.started = None
            self.interrupted = False
            self.current_image = None

    def start(self, job: str, total_steps: int):
        with self._lock:
            self.job = job
            self.total_steps = total_steps
            self.done_steps = 0
            self.started = time.time()
            self.current_image = None

    def step(self, n: int = 1):
        with self._lock:
            self.done_steps += n

    def set_preview(self, data_url: Optional[str]):
        """Live preview for /sdapi/v1/progress (the reference stubs the
        whole endpoint; A1111 semantics fill current_image mid-job)."""
        with self._lock:
            self.current_image = data_url

    def snapshot(self) -> dict:
        with self._lock:
            frac = self.done_steps / self.total_steps if self.total_steps else 0.0
            eta = 0.0
            if self.started and 0 < frac < 1:
                elapsed = time.time() - self.started
                eta = elapsed / frac * (1 - frac)
            active = bool(self.job) and frac < 1
            return {
                "progress": round(frac, 4),
                "eta_relative": round(eta, 2),
                "state": {
                    "skipped": False,
                    "interrupted": self.interrupted,
                    "job": self.job if active else "",
                    "job_count": 1 if active else 0,
                    "job_timestamp": time.strftime(
                        "%Y%m%d%H%M%S", time.localtime(self.started)
                    )
                    if self.started
                    else "",
                },
                "current_image": self.current_image if active else None,
                "textinfo": f"Step {self.done_steps}/{self.total_steps}"
                if active
                else "Idle",
            }


class FluxAPI:
    """Unified API for the UI and external A1111-style calls."""

    def __init__(self, pipeline_factory=None, sd_factory=None, max_queue: int = 8,
                 quantize: bool = False, w8a8: Optional[str] = None,
                 budget_gb: Optional[float] = None):
        self.pipeline = None
        self.sd_pipeline = None
        # model names are tracked per slot so alternating flux/SD requests
        # don't evict each other's resident pipeline (ADVICE r1)
        self.current_flux_model = None
        self.current_sd_model = None
        self.progress = ProgressTracker()
        self.quantize = quantize
        self.w8a8 = w8a8
        self._gen_lock = threading.Lock()
        # bounded admission: one request generates, up to max_queue-1 wait on
        # the lock, anything beyond is rejected with 429
        self._queue_slots = threading.BoundedSemaphore(max_queue)
        self._pipeline_factory = pipeline_factory
        self._sd_factory = sd_factory
        self.music_pipeline = None
        self._music_factory = None
        # resident-set planner: each load's weight policy and LRU eviction
        from .memory import MemoryPlanner

        self.memory = MemoryPlanner(budget_gb)
        # cross-user coalescing: waiting requests with one key run as one batch
        self._pending: dict = {}
        self._batch_lock = threading.Lock()
        # the JAX package's coalescing ladders; the last entry caps a group
        self.coalesce_buckets = (1, 2, 4)
        self.coalesce_buckets_sd = (1, 2, 4, 8)
        self.coalesce_buckets_sdxl = (1, 2, 4, 8)

    @contextlib.contextmanager
    def _admit(self):
        if not self._queue_slots.acquire(blocking=False):
            raise QueueFullError("generation queue full, retry later")
        try:
            with self._gen_lock:
                yield
        finally:
            self._queue_slots.release()

    # -------------------------------------------------- pipeline cache

    def _evict_slot(self, slot: str) -> None:
        if slot == "flux":
            self.pipeline = None
            self.current_flux_model = None
        elif slot == "sd":
            self.sd_pipeline = None
            self.current_sd_model = None
        elif slot == "musicgen":
            self.music_pipeline = None
        self.memory.note_evict(slot)
        import gc

        gc.collect()

    def _plan_load(self, slot: str, model: str) -> str:
        """Run the memory planner for a cold load: evict whatever it says,
        return the weight policy ("bf16"/"int8"/"int4"; `quantize` makes it
        int8 at least)."""
        plan = self.memory.plan(slot, model)
        for victim in plan.evict:
            self._evict_slot(victim)
        if plan.policy == "bf16" and self.quantize:
            return "int8"
        return plan.policy

    def _configure(self, pipeline):
        """Set the API's W8A8 route on a pipeline it loaded."""
        if self.w8a8 is not None and hasattr(pipeline, "w8a8"):
            pipeline.w8a8 = self.w8a8
        return pipeline

    def init_pipeline(self, model: str):
        """One flux slot + one sd slot, keyed by model name (flux_app.py:
        71-88), with resident-set planning: the planner picks each load's
        weight policy (bf16/int8) and evicts LRU slots only when even int8
        cannot co-reside — so alternating flux/SD(XL) requests pay zero
        reloads."""
        if model.startswith("stabilityai/"):
            if self.sd_pipeline is None or self.current_sd_model != model:
                if self.sd_pipeline is not None:
                    # drop the old model BEFORE planning: plan() treats the
                    # slot as free, and keeping the old pipeline alive
                    # through from_pretrained would double-count HBM
                    # mid-load (OOM on a same-slot 12B switch)
                    self._evict_slot("sd")
                policy = self._plan_load("sd", model)
                if self._sd_factory is not None:
                    pipe = self._sd_factory(model)
                else:
                    from ..pipelines.sd import StableDiffusion, StableDiffusionXL

                    cls = StableDiffusionXL if "sdxl-turbo" in model else StableDiffusion
                    pipe = cls.from_pretrained(model, quantize=policy != "bf16")
                self.sd_pipeline = self._configure(pipe)
                self.current_sd_model = model
                self.memory.note_load("sd", model, self.sd_pipeline, policy)
            self.memory.note_use("sd")
            return self.sd_pipeline
        flux_model = model if model.startswith("flux-") else f"flux-{model}"
        if self.pipeline is None or self.current_flux_model != flux_model:
            if self.pipeline is not None:
                self._evict_slot("flux")  # see the sd branch above
            policy = self._plan_load("flux", flux_model)
            if self._pipeline_factory is not None:
                pipe = self._pipeline_factory(flux_model)
            else:
                from ..pipelines.flux import FluxPipeline

                pipe = FluxPipeline.from_pretrained(
                    flux_model, quantize=policy if policy != "bf16" else False)
            self.pipeline = self._configure(pipe)
            self.current_flux_model = flux_model
            self.memory.note_load("flux", flux_model, self.pipeline, policy)
        self.memory.note_use("flux")
        return self.pipeline

    def init_music_pipeline(self):
        """The MusicGen slot, loaded once and kept."""
        if self.music_pipeline is None:
            policy = self._plan_load("musicgen", "musicgen")
            if self._music_factory is not None:
                pipe = self._music_factory()
            else:
                from ..pipelines.musicgen import MusicGenPipeline

                pipe = MusicGenPipeline.from_pretrained(quantize=policy != "bf16")
            self.music_pipeline = self._configure(pipe)
            self.memory.note_load("musicgen", "musicgen", self.music_pipeline,
                                  policy)
        self.memory.note_use("musicgen")
        return self.music_pipeline

    # -------------------------------------------------- coalesced generation

    @_request
    def generate_coalesced(self, prompt: str, model: str, width: int,
                           height: int, steps: Optional[int], guidance: float,
                           seed: Optional[int], n_images: int = 1,
                           negative: str = ""):
        """n_images through the coalescing batcher: requests with the same
        (model, size, steps, guidance, negative) that wait on the generation
        lock denoise as one batch, Flux and SD / SDXL alike, and a request
        for n images enters as n items, so they batch with other users' too.
        Returns n_images data URLs in request order."""
        is_sd = model.startswith("stabilityai/")
        if is_sd:
            steps = steps or (2 if "sdxl-turbo" in model else 50)
            if "sdxl-turbo" in model and guidance == 4.0:
                guidance = 0.0
        else:
            steps = steps or (50 if model in ("flux-dev", "dev") else 2)
            model = model if model.startswith("flux-") else f"flux-{model}"
        key = (model, width, height, steps, float(guidance), negative)
        if seed is None:
            # A1111 seed=-1: a fresh random seed per request (the batched
            # pipelines map None to a fixed seed)
            import random as _random

            seed = _random.randrange(1 << 30)
        items = [
            {"prompt": prompt,
             "seed": seed + j if seed is not None else None,
             "event": threading.Event(), "result": None, "error": None,
             "queued": time.time_ns(), "request": current_request()}
            for j in range(n_images)
        ]
        with self._batch_lock:
            self._pending.setdefault(key, []).extend(items)
        try:
            with self._admit():
                # as leader, drain until every own item is served: a request
                # past the cap must not leave its tail to a later leader
                while not all(it["event"].is_set() for it in items):
                    with self._batch_lock:
                        group = self._pending.pop(key, [])
                        if not group:
                            break
                        cap = self._buckets_for(model)[-1]
                        take, rest = group[:cap], group[cap:]
                        if rest:
                            self._pending[key] = rest
                    with _batch(take):
                        self._run_batch(take, model, width, height, steps,
                                        guidance, negative)
        except QueueFullError:
            with self._batch_lock:
                grp = self._pending.get(key, [])
                for it in items:
                    if it in grp:
                        grp.remove(it)
            if not all(it["event"].is_set() for it in items):
                raise
        for it in items:
            it["event"].wait()
        for it in items:
            if it["error"] is not None:
                raise it["error"]
        return [it["result"] for it in items]

    def _buckets_for(self, model: str):
        """The coalescing ladder of a model's family (its last entry caps a
        group): Flux 4, SD and SDXL 8."""
        if not model.startswith("stabilityai/"):
            return self.coalesce_buckets
        if "xl" in model.split("/")[-1]:
            return self.coalesce_buckets_sdxl
        return self.coalesce_buckets_sd

    def _run_batch(self, items, model, width, height, steps, guidance,
                   negative=""):
        if model.startswith("stabilityai/"):
            return self._run_sd_batch(items, model, width, height, steps,
                                      guidance, negative)
        return self._run_flux_batch(items, model, width, height, steps,
                                    guidance)

    def _run_sd_batch(self, items, model, width, height, steps, guidance,
                      negative):
        import time as _time

        try:
            t_start = _time.time()
            pipeline = self.init_pipeline(model)
            latent_size = to_latent_size((height, width))
            n = len(items)
            self.progress.start(f"txt2img:{model} (batch {n})", steps + n)
            preview_every = max(1, steps // 4) if steps > 4 else 0
            if hasattr(pipeline, "generate_latents_batch"):
                texts = [it["prompt"] for it in items]
                seeds = [it["seed"] for it in items]
                gen = pipeline.generate_latents_batch(
                    texts, seeds,
                    num_steps=steps, cfg_weight=guidance,
                    negative_text=negative, latent_size=latent_size,
                )
                x_t = None
                for i, x_t in enumerate(gen):
                    self.progress.step()
                    if preview_every and (i + 1) % preview_every == 0 and i + 1 < steps:
                        self.progress.set_preview(
                            self._latent_preview(x_t, model, latent_size)
                        )
                for i, it in enumerate(items):
                    it["result"] = _encode(
                        _fetch_u8(pipeline, x_t[i : i + 1])[0]
                    )
                    self.progress.step()
            else:
                # mock/legacy pipelines without the batched entry
                for it in items:
                    x_t = None
                    for x_t in pipeline.generate_latents(
                        it["prompt"], n_images=1, num_steps=steps,
                        cfg_weight=guidance, negative_text=negative,
                        latent_size=latent_size, seed=it["seed"],
                    ):
                        self.progress.step()
                    it["result"] = _encode(
                        _fetch_u8(pipeline, x_t[0:1])[0]
                    )
            self.last_stats = {"total_s": round(_time.time() - t_start, 3),
                               "batched_requests": n}
        except Exception as e:  # noqa: BLE001 — deliver to every waiter
            for it in items:
                it["error"] = e
        finally:
            self.progress.start("", 0)
            for it in items:
                it["event"].set()

    def _run_flux_batch(self, items, flux_model, width, height, steps, guidance):
        import time as _time

        try:
            t_start = _time.time()
            pipeline = self.init_pipeline(flux_model)
            latent_size = to_latent_size((height, width))
            n = len(items)
            if (
                n == 1 and steps <= 4
                and hasattr(pipeline, "generate_images_fused")
            ):
                # a single short request: one call from tokens to uint8
                # images, no host synchronisation between its phases
                # (previews are off at <= 4 steps anyway)
                it = items[0]
                self.progress.start(f"txt2img:{flux_model}", 1)
                img = _host(pipeline.generate_images_fused(
                    it["prompt"], num_steps=steps, guidance=guidance,
                    latent_size=latent_size, seed=it["seed"],
                ))
                it["result"] = _encode(img[0])
                self.progress.step()
                self.last_stats = {
                    "total_s": round(_time.time() - t_start, 3),
                    "fused_one_program": True,
                }
                return
            if not hasattr(pipeline, "generate_latents_batch"):
                # legacy/mock pipelines: serve the group one by one
                self.progress.start(f"txt2img:{flux_model}", n * (steps + 1))
                for it in items:
                    gen = pipeline.generate_latents(
                        it["prompt"], n_images=1, num_steps=steps,
                        latent_size=latent_size, guidance=guidance,
                        seed=it["seed"],
                    )
                    next(gen)
                    x_t = None
                    preview_every = max(1, steps // 4) if steps > 4 else 0
                    for i, x_t in enumerate(gen):
                        self.progress.step()
                        if preview_every and (i + 1) % preview_every == 0 and i + 1 < steps:
                            self.progress.set_preview(
                                self._latent_preview(x_t, flux_model, latent_size)
                            )
                    it["result"] = _encode(
                        _fetch_u8(pipeline, x_t[0:1], latent_size)[0]
                    )
                    self.progress.step()
                self.last_stats = {"total_s": round(_time.time() - t_start, 3),
                                   "batched_requests": n}
                return
            texts = [it["prompt"] for it in items]
            seeds = [it["seed"] for it in items]
            self.progress.start(f"txt2img:{flux_model} (batch {n})", steps + n)
            latents = pipeline.generate_latents_batch(
                texts, seeds, num_steps=steps, guidance=guidance,
                latent_size=latent_size,
            )
            next(latents)  # conditioning
            x_t = None
            preview_every = max(1, steps // 4) if steps > 4 else 0
            for i, x_t in enumerate(latents):
                self.progress.step()
                if preview_every and (i + 1) % preview_every == 0 and i + 1 < steps:
                    self.progress.set_preview(
                        self._latent_preview(x_t, flux_model, latent_size)
                    )
            images = []
            for i in range(n):
                images.append(_encode(
                    _fetch_u8(pipeline, x_t[i : i + 1], latent_size)[0]
                ))
                self.progress.step()
            from ..runtime.profiling import peak_memory_gb

            self.last_stats = {
                "total_s": round(_time.time() - t_start, 3),
                "batched_requests": n,
                "peak_hbm_gb": round(peak_memory_gb(), 3),
            }
            for it, img in zip(items, images):
                it["result"] = img
        except Exception as e:  # noqa: BLE001 — deliver to every waiter
            for it in items:
                it["error"] = e
        finally:
            self.progress.start("", 0)
            for it in items:
                it["event"].set()

    # -------------------------------------------------- txt2img

    def txt2img(self, request: SDAPIRequest) -> SDAPIResponse:
        n_images = request.batch_size * request.n_iter
        if n_images <= self._buckets_for(request.model or "")[-1]:
            # flux AND sd requests up to a bucket ride the cross-user
            # batcher; a k-image request enters as k items so it coalesces
            # with other users' too
            images = self.generate_coalesced(
                prompt=request.prompt,
                model=request.model,
                width=request.width,
                height=request.height,
                steps=request.steps,
                guidance=request.cfg_scale,
                seed=request.seed if request.seed >= 0 else None,
                n_images=n_images,
                negative=request.negative_prompt or "",
            )
            stats = getattr(self, "last_stats", {})
            return SDAPIResponse(
                images=images,
                parameters={
                    "prompt": request.prompt,
                    "negative_prompt": request.negative_prompt,
                    "width": request.width,
                    "height": request.height,
                    "steps": request.steps,
                    "cfg_scale": request.cfg_scale,
                    "seed": request.seed,
                    "model": request.model,
                },
                info=f"Generated with Flux {request.model} model"
                     + (f" | total {stats.get('total_s')}s, coalesced batch "
                        f"{stats.get('batched_requests')}" if stats else ""),
            )
        images = self.generate_images(
            prompt=request.prompt,
            model=request.model,
            width=request.width,
            height=request.height,
            steps=request.steps,
            guidance=request.cfg_scale,
            negative_prompt=request.negative_prompt or "",
            seed=request.seed if request.seed >= 0 else None,
            batch_size=request.batch_size,
            n_iter=request.n_iter,
            return_pil=False,
        )
        stats = getattr(self, "last_stats", {})
        stat_str = (
            f" | cond {stats.get('conditioning_s')}s, gen {stats.get('generation_s')}s, "
            f"decode {stats.get('decode_s')}s, peak HBM {stats.get('peak_hbm_gb')} GB"
            if stats
            else ""
        )
        return SDAPIResponse(
            images=images,
            parameters={
                "prompt": request.prompt,
                "negative_prompt": request.negative_prompt,
                "width": request.width,
                "height": request.height,
                "steps": request.steps,
                "cfg_scale": request.cfg_scale,
                "seed": request.seed,
                "model": request.model,
            },
            info=f"Generated with Flux {request.model} model{stat_str}",
        )

    @_request
    def generate_images(
        self,
        prompt: str,
        model: str = "schnell",
        width: int = 512,
        height: int = 512,
        steps: Optional[int] = None,
        guidance: float = 4.0,
        negative_prompt: str = "",
        seed: Optional[int] = None,
        batch_size: int = 1,
        n_iter: int = 1,
        return_pil: bool = False,
    ) -> List[Union[str, object]]:
        import time as _time

        with self._admit():
            t_start = _time.time()
            pipeline = self.init_pipeline(model)
            latent_size = to_latent_size((height, width))
            n_images = batch_size * n_iter

            if model.startswith("stabilityai/"):
                steps = steps or (2 if "sdxl-turbo" in model else 50)
                guidance = 0.0 if ("sdxl-turbo" in model and guidance == 4.0) else guidance
                self.progress.start(f"txt2img:{model}", steps + n_images)
                latents = pipeline.generate_latents(
                    prompt,
                    n_images=n_images,
                    cfg_weight=guidance,
                    num_steps=steps,
                    negative_text=negative_prompt,
                    latent_size=latent_size,
                    seed=seed,
                )
            else:
                steps = steps or (50 if model in ("flux-dev", "dev") else 2)
                self.progress.start(f"txt2img:{model}", steps + n_images)
                latents = pipeline.generate_latents(
                    prompt,
                    n_images=n_images,
                    num_steps=steps,
                    latent_size=latent_size,
                    guidance=guidance,
                    seed=seed,
                )
                next(latents)  # conditioning (generator protocol)
            t_cond = _time.time()

            x_t = None
            # live previews: at most about 3 a job, none on short jobs (each
            # one copies a latent to the host)
            preview_every = max(1, steps // 4) if steps > 4 else 0
            for i, x_t in enumerate(latents):
                self.progress.step()
                if preview_every and (i + 1) % preview_every == 0 and i + 1 < steps:
                    self.progress.set_preview(
                        self._latent_preview(x_t, model, latent_size)
                    )
            t_gen = _time.time()

            decoded = []
            for i in range(n_images):
                if model.startswith("stabilityai/"):
                    decoded.append(_fetch_u8(pipeline, x_t[i : i + 1]))
                else:
                    decoded.append(_fetch_u8(pipeline, x_t[i : i + 1], latent_size))
                self.progress.step()

            images = []
            for img in decoded:
                arr = img[0]
                if return_pil:
                    from PIL import Image

                    images.append(Image.fromarray(arr))
                else:
                    images.append(_encode(arr))
            # per-request phase stats (the UI's stats panel), with the
            # device's peak memory
            from ..runtime.profiling import peak_memory_gb

            self.last_stats = {
                "conditioning_s": round(t_cond - t_start, 3),
                "generation_s": round(t_gen - t_cond, 3),
                "decode_s": round(_time.time() - t_gen, 3),
                "total_s": round(_time.time() - t_start, 3),
                "peak_hbm_gb": round(peak_memory_gb(), 3),
            }
            self.progress.start("", 0)
            return images

    def _latent_preview(self, x_t, model: str, latent_size):
        """Cheap mid-job preview: first 3 latent channels normalized to RGB
        (A1111 'approx' preview style — no VAE pass)."""
        try:
            if model.startswith("stabilityai/"):
                lat = _host(x_t[0:1])[0]
            else:
                from ..pipelines.flux import unpack_latents

                lat = _host(unpack_latents(x_t[0:1], *latent_size))[0]
            rgb = lat[..., :3].astype(np.float32)
            rng = float(rgb.max() - rgb.min())
            rgb = (rgb - rgb.min()) / (rng + 1e-6)
            return _png_data_url((rgb * 255).astype(np.uint8))
        except Exception:
            return None

    # -------------------------------------------------- img2img

    @_request
    def img2img(self, request) -> SDAPIResponse:
        """A1111 /sdapi/v1/img2img, for the SD family and Flux
        (generate_latents_from_image)."""
        import base64
        import io as _io

        import torch
        from PIL import Image

        is_sd = request.model.startswith("stabilityai/")
        if max(request.width, request.height) > MAX_SIDE:
            raise ValueError(
                f"requested size {request.width}x{request.height} exceeds "
                f"the serving cap of {MAX_SIDE}px per side"
            )
        with self._admit():
            pipeline = self.init_pipeline(request.model)
            raw = request.init_images[0]
            if raw.startswith("data:"):
                raw = raw.split(",", 1)[1]
            img = Image.open(_io.BytesIO(base64.b64decode(raw))).convert("RGB")
            # SD UNet levels need 64-px alignment; flux packing needs 16
            snap = 64 if is_sd else 16
            w = max((request.width // snap) * snap, snap)
            h = max((request.height // snap) * snap, snap)
            img = img.resize((w, h))
            arr = torch.from_numpy(np.array(img)).float() / 255 * 2 - 1

            default_steps = (2 if "sdxl-turbo" in request.model else 50) if is_sd \
                else (2 if "schnell" in request.model else 35)
            steps = request.steps or default_steps
            seed = request.seed if request.seed >= 0 else None
            self.progress.start(
                f"img2img:{request.model}", max(int(steps * request.denoising_strength), 1)
            )
            x_t = None
            if is_sd:
                gen = pipeline.generate_latents_from_image(
                    arr, request.prompt, n_images=request.batch_size,
                    strength=request.denoising_strength, num_steps=steps,
                    cfg_weight=request.cfg_scale,
                    negative_text=request.negative_prompt or "",
                    seed=seed,
                )
                latent_size = None
            else:
                gen = pipeline.generate_latents_from_image(
                    arr, request.prompt, n_images=request.batch_size,
                    strength=request.denoising_strength, num_steps=steps,
                    guidance=request.cfg_scale, seed=seed,
                )
                next(gen)  # flux protocol yields conditioning first
                ds = getattr(pipeline, "ae_downsample", 8)
                latent_size = (h // ds, w // ds)
            for x_t in gen:
                self.progress.step()
            images = []
            for i in range(request.batch_size):
                images.append(_encode(
                    _fetch_u8(pipeline, x_t[i : i + 1], latent_size)[0]
                ))
            self.progress.start("", 0)
        return SDAPIResponse(
            images=images,
            parameters=request.model_dump(exclude={"init_images"}),
            info=f"img2img with {request.model}",
        )

    # -------------------------------------------------- music

    @_request
    def generate_music(self, prompt: str, max_steps: int = 500, top_k: int = 250,
                       temperature: float = 1.0, guidance: float = 3.0,
                       seed: Optional[int] = None, n_samples: int = 1):
        """Returns (waveforms, sampling_rate): waveforms is a list of (T, C)
        arrays. Music requests coalesce as images do: waiting requests with
        the same (top_k, temperature, guidance) run in one batched AR loop
        with their own prompts, durations and seeds (generate_requests), up
        to 4; a request for n samples enters as n items."""
        max_steps = max(8, min(int(max_steps), 2500))
        n_samples = max(1, min(int(n_samples), 4))
        key = ("music", int(top_k), float(temperature), float(guidance))
        items = [
            {"prompt": prompt, "steps": max_steps,
             "seed": seed + j if seed is not None else None,
             "event": threading.Event(), "result": None, "error": None,
             "queued": time.time_ns(), "request": current_request()}
            for j in range(n_samples)
        ]
        with self._batch_lock:
            self._pending.setdefault(key, []).extend(items)
        try:
            with self._admit():
                while not all(it["event"].is_set() for it in items):
                    with self._batch_lock:
                        group = self._pending.pop(key, [])
                        if not group:
                            break
                        # at most 4 requests: 8 CFG rows in the decode step
                        take, rest = group[:4], group[4:]
                        if rest:
                            self._pending[key] = rest
                    with _batch(take):
                        self._run_music_batch(take, top_k, temperature, guidance)
        except QueueFullError:
            with self._batch_lock:
                grp = self._pending.get(key, [])
                for it in items:
                    if it in grp:
                        grp.remove(it)
            if not all(it["event"].is_set() for it in items):
                raise
        for it in items:
            it["event"].wait()
        for it in items:
            if it["error"] is not None:
                raise it["error"]
        return [it["result"] for it in items], self.init_music_pipeline().sampling_rate

    def _run_music_batch(self, items, top_k, temperature, guidance):
        try:
            pipe = self.init_music_pipeline()
            self.progress.start(
                f"musicgen (batch {len(items)})",
                max(it["steps"] for it in items),
            )
            if hasattr(pipe, "generate_requests"):
                reqs = [
                    {"text": it["prompt"], "max_steps": it["steps"],
                     "seed": it["seed"]}
                    for it in items
                ]
                audios = pipe.generate_requests(
                    reqs, top_k=top_k, temp=temperature,
                    guidance_coef=guidance,
                )
                for it, a in zip(items, audios):
                    it["result"] = _host(a)
            else:
                # mock/legacy pipelines without the coalesced entry
                for it in items:
                    it["result"] = _host(pipe.generate(
                        it["prompt"], max_steps=it["steps"], top_k=top_k,
                        temp=temperature, guidance_coef=guidance,
                        seed=it["seed"],
                    ))
        except Exception as e:  # noqa: BLE001 — deliver to every waiter
            for it in items:
                it["error"] = e
        finally:
            self.progress.start("", 0)
            for it in items:
                it["event"].set()

    # -------------------------------------------------- A1111 metadata

    def list_models(self):
        def entry(title, name):
            return {
                "title": title,
                "name": name,
                "model_name": title,
                "hash": None,
                "sha256": None,
                "filename": f"{title.split('/')[-1]}.safetensors",
                "config": None,
            }

        return [
            entry("flux-schnell", "Flux Schnell (Fast)"),
            entry("flux-dev", "Flux Dev (High Quality)"),
            entry("stabilityai/stable-diffusion-2-1-base", "SD 2.1 Base (High Quality)"),
            entry("stabilityai/sdxl-turbo", "SDXL Turbo (Fast)"),
        ]

    def get_options(self):
        return {
            "sd_model_checkpoint": "stabilityai/stable-diffusion-2-1-base",
            "sd_backend": "Flux (PyTorch, CUDA)",
            "sd_model_list": [
                {"title": "Flux Schnell (Fast)", "name": "flux-schnell",
                 "model_name": "flux-schnell"},
                {"title": "SD 2.1 Base (High Quality)",
                 "name": "stabilityai/stable-diffusion-2-1-base",
                 "model_name": "stabilityai/stable-diffusion-2-1-base"},
                {"title": "Flux Dev (High Quality)", "name": "flux-dev",
                 "model_name": "flux-dev"},
                {"title": "SDXL Turbo (Fast)", "name": "stabilityai/sdxl-turbo",
                 "model_name": "stabilityai/sdxl-turbo"},
            ],
        }

    def set_options(self, options: dict):
        return {"success": True}

    def get_progress(self):
        return self.progress.snapshot()


def _host(x) -> np.ndarray:
    """A torch tensor (on any device) or array-like as a host numpy array;
    bf16 and f16 tensors widen to f32."""
    if hasattr(x, "detach"):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _png_data_url(arr) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _encode(arr) -> str:
    """A served image's PNG data URL, in a `fgt.engine.encode` span."""
    with span("fgt.engine.encode"):
        return _png_data_url(arr)


def _fetch_u8(pipeline, x, latent_size=None):
    """Decode latents to a host uint8 RGB array (B, H, W, 3): through the
    pipeline's uint8 decode on the device where it has one (4x fewer bytes
    to copy than float), else its float decode converted on the host
    (mocks)."""
    args = (x,) if latent_size is None else (x, latent_size)
    if hasattr(pipeline, "decode_u8"):
        return _host(pipeline.decode_u8(*args))
    img = _host(pipeline.decode(*args))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
