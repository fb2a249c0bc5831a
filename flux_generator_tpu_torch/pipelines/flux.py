"""Flux text-to-image pipeline (counterpart of flux_generator_tpu/pipelines/flux.py).

tokenize → T5 / CLIP conditioning → 2x2 latent patchify with 3-axis
position ids → flow-matching Euler denoise → unpatchify + VAE decode (tiled
above 128² latents, one image at a time past one 1024² image), plus the
conditioning-first generator protocol that the server drives step by step
(`generate_latents`, `generate_latents_batch`), img2img
(`generate_latents_from_image`, on the VAE encode, tiled above 1024 px), the
one-call request `generate_images_fused`, and the flow-matching training
loss that DreamBooth LoRA training runs. The device is the one the params lie
on; noise comes from a `torch.Generator` seeded per request. PyTorch runs
eagerly, so the JAX package's jitted whole-schedule program becomes a plain
loop over the schedule. Host data (tokens, the schedule) reaches the card
through pinned memory without waiting for it, so a request queues all its
device work without a host synchronisation.

`w8a8` and `attn_int8` are the W8A8 serving configuration: the JAX
package's process-wide `set_w8a8(True)` (with FGT_W8A8_IMPL) and
`set_attn_int8`, here attributes of the pipeline passed to every encoder
and flow call of a request (see ops.linear.dense and
ops.kernels.flash_attention). Set them before a request, or between two.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..io.params import tree_leaves
from ..models.clip.text import CLIPTextConfig, clip_text_forward, init_clip_text, tiny_clip_config
from ..models.flux import autoencoder as ae_mod
from ..models.flux import sampler as sampler_mod
from ..models.flux.autoencoder import AutoEncoderConfig, tiny_ae_config
from ..models.flux.model import FluxConfig, flux_forward, init_flux, tiny_flux_config
from ..models.t5.t5 import T5Config, init_t5_encoder, t5_encode, tiny_t5_config
from ..ops.tiling import batched_apply, tiled_decode_2d
from ..runtime.device import as_device, make_generator, synchronize, to_device
from ..runtime.profiling import span


# ------------------------------------------------------------ latent packing


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, c) → (B, h·w/4, 4c): 2x2 patch packing."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, h * w // 4, c * 4)


def unpack_latents(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h·w/4, 4c) → (B, h, w, c)."""
    b = x.shape[0]
    x = x.reshape(b, h // 2, w // 2, -1, 2, 2)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, h, w, -1)


def latent_ids(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """3-axis position ids (const 0, row, col) for packed patches."""
    j, k = torch.meshgrid(torch.arange(h // 2, device=device), torch.arange(w // 2, device=device),
                          indexing="ij")
    ids = torch.stack([torch.zeros_like(j), j, k], dim=-1).reshape(1, -1, 3)
    return ids.expand(batch, h * w // 4, 3)


# ------------------------------------------------------------ pipeline


class FluxPipeline:
    def __init__(self, name: str, params: dict, flow_cfg: FluxConfig, ae_cfg: AutoEncoderConfig,
                 clip_cfg: CLIPTextConfig, t5_cfg: T5Config, clip_tokenizer=None,
                 t5_tokenizer=None, dtype=torch.bfloat16, w8a8: Optional[str] = None,
                 attn_int8: str = ""):
        self.name = name
        self.params = params
        self.flow_cfg = flow_cfg
        self.ae_cfg = ae_cfg
        self.clip_cfg = clip_cfg
        self.t5_cfg = t5_cfg
        self.clip_tokenizer = clip_tokenizer
        self.t5_tokenizer = t5_tokenizer
        self.dtype = dtype
        self.schnell = "schnell" in name
        self.w8a8 = w8a8
        self.attn_int8 = attn_int8
        # the parallel layouts set by shard, enable_pipeline_parallel and
        # enable_ring_attention, passed to every flow (and T5) call
        self.tp = None
        self.pp = None
        self.ring = None

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params["flow"])[0].device

    # -------------------------------------------------- constructors

    @classmethod
    def random_init(cls, name: str = "flux-schnell", tiny: bool = False, dtype=torch.bfloat16,
                    device=None, generator: Optional[torch.Generator] = None,
                    w8a8: Optional[str] = None, attn_int8: str = "", **cfg_overrides):
        """Randomly initialized pipeline (tests, benchmarks, offline runs) on
        `device`, drawn from `generator` (seed 0 on `device` when None).
        With neither given it builds on the current CUDA device, and raises
        where there is none."""
        from ..io.registry import flux_configs

        device = as_device(device if device is not None
                           else (generator.device if generator is not None else None))
        generator = generator if generator is not None else make_generator(device, 0)
        if tiny:
            flow_cfg = tiny_flux_config(guidance_embed="dev" in name, **cfg_overrides)
            ae_cfg = tiny_ae_config(z_channels=flow_cfg.in_channels // 4)
            clip_cfg = tiny_clip_config(model_dims=flow_cfg.vec_in_dim)
            t5_cfg = tiny_t5_config(d_model=flow_cfg.context_in_dim)
        else:
            flow_cfg, ae_cfg, clip_cfg, t5_cfg = flux_configs(name)
        params = {
            "flow": init_flux(generator, flow_cfg, dtype, device),
            "ae": ae_mod.init_autoencoder(generator, ae_cfg, dtype, device),
            "clip": init_clip_text(generator, clip_cfg, dtype, device),
            "t5": init_t5_encoder(generator, t5_cfg, dtype, device),
        }
        return cls(name, params, flow_cfg, ae_cfg, clip_cfg, t5_cfg, dtype=dtype, w8a8=w8a8,
                   attn_int8=attn_int8)

    @classmethod
    def from_pretrained(cls, name: str = "flux-schnell", dtype=torch.bfloat16, device=None, **kwargs):
        """The pipeline of a checkpoint (io/loaders.load_flux_pipeline): the
        registry's repo in the local hub cache, or `local_dir=`; `quantize`
        False, True / "int8" or "int4"; on `device` (the current CUDA device
        when None)."""
        from ..io.loaders import load_flux_pipeline

        return load_flux_pipeline(name, dtype=dtype, device=device, **kwargs)

    # -------------------------------------------------- parallel layouts

    def shard(self, mesh=None):
        """Tensor-parallel the flow and T5 over the "model" axis of a ("data",
        "model") mesh (every rank of the process group on "model" when None):
        each rank keeps its shard of their weights (parallel/sharding.TP_PLAN)
        and runs its heads; CLIP and the autoencoder stay whole, the same on
        every rank. Every rank runs the same requests. Call once after load
        (and after quantizing)."""
        from ..parallel.mesh import create_mesh
        from ..parallel.sharding import replicate, shard_params

        if mesh is None:
            from ..parallel.distributed import world_size

            mesh = create_mesh(data=1, model=world_size())
        self.mesh = self.tp = mesh
        self.params["flow"] = shard_params(self.params["flow"], mesh)
        self.params["t5"] = shard_params(self.params["t5"], mesh)
        self.params["clip"] = replicate(self.params["clip"], mesh)
        self.params["ae"] = replicate(self.params["ae"], mesh)
        return self

    def enable_pipeline_parallel(self, mesh=None, axis: str = "pipe", microbatches: Optional[int] = None):
        """Pipeline-parallel the flow over the `mesh.size(axis)` stages of
        `axis` (every rank of the process group when mesh is None): each rank
        keeps a contiguous chunk of the double and single blocks, and
        microbatches stream through the stages GPipe-style
        (parallel/pipeline.py). The stacks are zero-padded to a stage
        multiple (zero blocks are exact identities). Enable after quantizing
        or fusing LoRA, before the first request."""
        from ..parallel.mesh import Mesh
        from ..parallel.pipeline import pad_stack, shard_pipeline_params

        if mesh is None:
            from ..parallel.distributed import world_size

            mesh = Mesh({axis: world_size()})
        flow = self.params["flow"]
        for name in ("double_blocks", "single_blocks"):
            padded, _ = pad_stack(flow[name], mesh.size(axis))
            flow[name] = shard_pipeline_params(padded, mesh, axis)
        self.pp = (mesh, axis, microbatches)
        return self

    def enable_ring_attention(self, mesh=None, axis: str = "model", threshold: int = 32768):
        """Sequence-parallel attention for very large images: every attention
        of length ≥ threshold that divides over `axis` of `mesh` (every rank
        of the process group when None) runs as ring attention
        (parallel/ring_attention.py), rotating K/V shards around the axis;
        shorter ones keep the one-device path. The switch is this
        pipeline's, passed to each flow call."""
        from ..parallel.mesh import create_mesh

        if mesh is None:
            from ..parallel.distributed import world_size

            mesh = create_mesh(data=1, model=world_size())
        self.ring = (mesh, axis, threshold)
        return self

    # -------------------------------------------------- text conditioning

    def tokenize(self, text: str):
        if self.t5_tokenizer is None or self.clip_tokenizer is None:
            raise RuntimeError("pipeline built without tokenizers; pass token arrays directly")
        device = self.device
        t5_tokens = to_device(self.t5_tokenizer.encode(text), torch.long, device)
        clip_tokens = to_device(self.clip_tokenizer.encode(text), torch.long, device)
        return t5_tokens, clip_tokens

    def prepare_conditioning(self, n_images: int, t5_tokens, clip_tokens):
        with span("fgt.flux.cond", t5_tokens.device):
            txt = t5_encode(self.params["t5"], self.t5_cfg, t5_tokens, self.w8a8, self.tp).to(self.dtype)
            if txt.shape[0] == 1 and n_images > 1:
                txt = txt.expand(n_images, *txt.shape[1:])
            txt_ids = torch.zeros((n_images, txt.shape[1], 3), dtype=torch.int32, device=txt.device)
            vec = clip_text_forward(self.params["clip"], self.clip_cfg, clip_tokens,
                                    self.w8a8)["pooled_output"]
            vec = vec.to(self.dtype)
            if vec.shape[0] == 1 and n_images > 1:
                vec = vec.expand(n_images, *vec.shape[1:])
            return txt, txt_ids, vec

    # -------------------------------------------------- denoising

    def timesteps(self, num_steps: int, image_seq_len: int) -> np.ndarray:
        return sampler_mod.flux_timesteps(num_steps, image_seq_len, self.schnell)

    def _step(self, x_t, x_ids, txt, txt_ids, vec, t, t_prev, guidance):
        b = x_t.shape[0]
        pred = flux_forward(
            self.params["flow"], self.flow_cfg, img=x_t, img_ids=x_ids, txt=txt,
            txt_ids=txt_ids, timesteps=t.expand(b), y=vec,
            guidance=guidance.expand(b) if self.flow_cfg.guidance_embed else None,
            w8a8=self.w8a8, attn_int8=self.attn_int8, tp=self.tp, pp=self.pp, ring=self.ring,
        )
        # t_prev − t is taken in the schedule's dtype, then promoted to x_t's
        return sampler_mod.flux_step(pred, x_t, t, t_prev)

    def _schedule(self, num_steps: int, image_seq_len: int, guidance: float, device):
        """The schedule (num_steps + 1,) and the guidance, in the working
        dtype on `device`: t_prev − t is taken in that dtype, as in the JAX
        package."""
        ts = to_device(self.timesteps(num_steps, image_seq_len), self.dtype, device)
        return ts, to_device(guidance, self.dtype, device)

    def _denoise_steps(self, x_t, x_ids, txt, txt_ids, vec, ts, g, start: int = 0):
        """Euler steps start .. len(ts) − 2, yielding each step's latent."""
        for i in range(start, ts.shape[0] - 1):
            with span("fgt.flux.step"):
                x_t = self._step(x_t, x_ids, txt, txt_ids, vec, ts[i], ts[i + 1], g)
            yield x_t

    def denoise_latents(self, x_t, x_ids, txt, txt_ids, vec, num_steps: int, guidance: float):
        """Euler steps over the whole schedule."""
        ts, g = self._schedule(num_steps, x_t.shape[1], guidance, x_t.device)
        for x_t in self._denoise_steps(x_t, x_ids, txt, txt_ids, vec, ts, g):
            pass
        return x_t

    # -------------------------------------------------- encoding

    @property
    def ae_downsample(self) -> int:
        """Spatial factor of the autoencoder (8 at full size; tiny test
        configs use fewer levels)."""
        return ae_mod.downsample(self.ae_cfg)

    def _encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, 3) in about [-1, 1] → latents (B, H/f, W/f, z),
        one image at a time past one 1024² image's pixels, and in
        overlapping 768² tiles (overlap 128, latent means blended) for an
        image above 1024 px on either side."""
        params, cfg = self.params["ae"], self.ae_cfg

        def encode(xt):
            return ae_mod.encode(params, cfg, xt)

        def one(xi):
            if max(xi.shape[1], xi.shape[2]) > 1024:
                return tiled_decode_2d(encode, xi, tile=768, overlap=128, factor=1 / self.ae_downsample)
            return encode(xi)

        return batched_apply(one, x, pixel_limit=1024 * 1024)

    # -------------------------------------------------- decoding

    def _decode(self, x, h: int, w: int, as_uint8: bool):
        """Latents → images, one image at a time past one 1024² image's
        latents, each in overlapping tiles (autoencoder.decode_tiled) above
        128² latents."""
        params, cfg = self.params["ae"], self.ae_cfg

        def one(zi):
            if max(h, w) > 128:
                return ae_mod.decode_tiled(params, cfg, zi)
            return ae_mod.decode(params, cfg, zi)

        with span("fgt.flux.vae", x.device):
            img = batched_apply(one, unpack_latents(x, h, w), pixel_limit=128 * 128)
            img = torch.clamp(img + 1, 0, 2) * 0.5
            if as_uint8:
                img = (torch.clamp(img, 0, 1).float() * 255).to(torch.uint8)
            return img

    def decode(self, x, latent_size: Tuple[int, int] = (64, 64)):
        return self._decode(x, *latent_size, as_uint8=False)

    def decode_u8(self, x, latent_size: Tuple[int, int] = (64, 64)):
        """Decode straight to uint8 RGB on the device."""
        return self._decode(x, *latent_size, as_uint8=True)

    # -------------------------------------------------- generation

    def generate_images(self, text: str, n_images: int = 1, num_steps: Optional[int] = None,
                        guidance: float = 4.0, latent_size: Tuple[int, int] = (64, 64),
                        seed: Optional[int] = None, as_uint8: bool = False,
                        trace: Optional[dict] = None):
        """Text → images (B, 8h, 8w, 3), float in [0, 1] or uint8.

        `trace`, when a dict is given, receives the seconds of each phase
        ("conditioning_s", "denoise_s", "decode_s", each ended by a device
        synchronize) and the final latent ("latent")."""
        num_steps = num_steps or (2 if self.schnell else 35)
        device = self.device
        h, w = latent_size

        def mark(key, t0):
            if trace is not None:
                synchronize(device)
                trace[key] = time.perf_counter() - t0
            return time.perf_counter()

        t0 = time.perf_counter()
        generator = make_generator(device, seed)
        x = sampler_mod.sample_prior(generator, (n_images, h, w, self.ae_cfg.z_channels), self.dtype)
        x_t = pack_latents(x)
        x_ids = latent_ids(n_images, h, w, device=device)
        t5_tokens, clip_tokens = self.tokenize(text)
        txt, txt_ids, vec = self.prepare_conditioning(n_images, t5_tokens, clip_tokens)
        t0 = mark("conditioning_s", t0)
        x_t = self.denoise_latents(x_t, x_ids, txt, txt_ids, vec, num_steps, guidance)
        t0 = mark("denoise_s", t0)
        img = self.decode_u8(x_t, latent_size) if as_uint8 else self.decode(x_t, latent_size)
        mark("decode_s", t0)
        if trace is not None:
            trace["latent"] = x_t
        return img

    def _protocol(self, x_t, x_ids, t5_tokens, clip_tokens, ts, g, start: int = 0):
        """The generator protocol's body: the conditioning tuple (x_t, x_ids,
        txt, txt_ids, vec), then the latent after each step from `start`."""
        txt, txt_ids, vec = self.prepare_conditioning(x_t.shape[0], t5_tokens, clip_tokens)
        yield x_t, x_ids, txt, txt_ids, vec
        yield from self._denoise_steps(x_t, x_ids, txt, txt_ids, vec, ts, g, start)

    def generate_latents(self, text: str, n_images: int = 1, num_steps: int = 35,
                         guidance: float = 4.0, latent_size: Tuple[int, int] = (64, 64),
                         seed: Optional[int] = None):
        """The generator protocol the server drives: yields the conditioning
        (x_t, x_ids, txt, txt_ids, vec) first, then the latent after each of
        the `num_steps` denoise steps."""
        device = self.device
        h, w = latent_size
        x = sampler_mod.sample_prior(make_generator(device, seed), (n_images, h, w, self.ae_cfg.z_channels),
                                     self.dtype)
        x_t = pack_latents(x)
        ts, g = self._schedule(num_steps, x_t.shape[1], guidance, device)
        yield from self._protocol(x_t, latent_ids(n_images, h, w, device=device), *self.tokenize(text), ts, g)

    def generate_latents_batch(self, texts, seeds, num_steps: int = 2, guidance: float = 4.0,
                               latent_size: Tuple[int, int] = (64, 64)):
        """Several prompts, one seed each, denoised as one batch (the server
        coalesces concurrent users into this): one prior per seed, the token
        rows concatenated. The same protocol as `generate_latents`."""
        if len(texts) != len(seeds):
            raise ValueError(f"{len(texts)} texts but {len(seeds)} seeds")
        device = self.device
        h, w = latent_size
        n = len(texts)
        rows = [self.tokenize(text) for text in texts]
        t5_tokens = torch.cat([t5 for t5, _ in rows])
        # CLIP rows come padded to their own length: pad each to the longest
        # with its last token (EOS), as the tokenizer pads a batch; CLIP is
        # causal and pools at the first EOS, so a row's pooled output keeps
        # its value
        width = max(clip.shape[1] for _, clip in rows)
        clip_tokens = torch.cat([torch.nn.functional.pad(clip, (0, width - clip.shape[1]), value=int(clip[0, -1]))
                                 for _, clip in rows])
        priors = [sampler_mod.sample_prior(make_generator(device, None if s is None else int(s)),
                                           (1, h, w, self.ae_cfg.z_channels), self.dtype) for s in seeds]
        x_t = pack_latents(torch.cat(priors))
        ts, g = self._schedule(num_steps, x_t.shape[1], guidance, device)
        yield from self._protocol(x_t, latent_ids(n, h, w, device=device), t5_tokens, clip_tokens, ts, g)

    def generate_latents_from_image(self, image, text: str, n_images: int = 1, strength: float = 0.8,
                                    num_steps: Optional[int] = None, guidance: float = 4.0,
                                    seed: Optional[int] = None):
        """Flux img2img: encode the image (B|1, H, W, 3) in [-1, 1], put it
        on the flow-matching schedule at start = min(round((1 − strength) ·
        num_steps), num_steps − 1) as x_t = (1 − t)·x₀ + t·ε with t =
        ts[start], and denoise the remaining steps. strength 1 is pure noise;
        a small strength stays near the input. The same protocol as
        `generate_latents`."""
        num_steps = num_steps or (2 if self.schnell else 35)
        device = self.device
        img = to_device(image, self.dtype, device)
        if img.dim() == 3:
            img = img[None]
        x0 = self._encode_image(img)
        h, w = x0.shape[1], x0.shape[2]
        x0 = pack_latents(x0)
        x0 = x0.expand(n_images, *x0.shape[1:])
        ts, g = self._schedule(num_steps, x0.shape[1], guidance, device)
        start = min(int(round((1 - strength) * num_steps)), num_steps - 1)
        eps = sampler_mod.sample_prior(make_generator(device, seed), tuple(x0.shape), self.dtype)
        x_t = sampler_mod.add_noise(x0, ts[start], eps)
        yield from self._protocol(x_t, latent_ids(n_images, h, w, device=device), *self.tokenize(text), ts, g,
                                  start)

    def generate_images_fused(self, text: str, num_steps: Optional[int] = None, guidance: float = 4.0,
                              latent_size: Tuple[int, int] = (64, 64), seed: Optional[int] = None):
        """The one-call request: tokens → T5 / CLIP → prior → denoise → uint8
        decode, for the batch of the token rows, with no host
        synchronisation between the phases (the JAX package's one-program
        path). The same uint8 images as `generate_images(..., as_uint8=True)`
        at the same seed."""
        num_steps = num_steps or (2 if self.schnell else 35)
        device = self.device
        h, w = latent_size
        t5_tokens, clip_tokens = self.tokenize(text)
        n = t5_tokens.shape[0]
        txt, txt_ids, vec = self.prepare_conditioning(n, t5_tokens, clip_tokens)
        x = sampler_mod.sample_prior(make_generator(device, seed), (n, h, w, self.ae_cfg.z_channels), self.dtype)
        x_t = self.denoise_latents(pack_latents(x), latent_ids(n, h, w, device=device), txt, txt_ids, vec,
                                   num_steps, guidance)
        return self._decode(x_t, h, w, as_uint8=True)

    # -------------------------------------------------- training

    def training_loss(self, flow_params, generator: torch.Generator, x_0, t5_features,
                      clip_features, guidance, rows: Optional[slice] = None, remat: str = "block"):
        """Flow-matching loss with timesteps from the schnell/dev schedule
        and noise, both drawn from `generator` for the whole batch: see
        `_training_loss_at`. `rows` takes the loss over those rows of the
        batch only (a data-parallel rank's share of the global batch, with
        the global batch's draws)."""
        b, h, w, c = x_0.shape
        t = sampler_mod.random_timesteps(generator, b, h * w // 4, self.schnell)
        eps = torch.randn((b, h * w // 4, 4 * c), generator=generator, device=generator.device,
                          dtype=torch.float32)
        t, eps = t.to(x_0.device), eps.to(x_0.device, x_0.dtype)
        if rows is not None:
            x_0, t, eps, t5_features, clip_features = (v[rows] for v in (x_0, t, eps, t5_features, clip_features))
            guidance = None if guidance is None else guidance[rows]
        return self._training_loss_at(flow_params, x_0, t, eps, t5_features, clip_features, guidance, remat)

    def _training_loss_at(self, flow_params, x_0, t, eps, t5_features, clip_features, guidance,
                          remat: str = "block"):
        """mean((pred + x_0 − eps)²) in f32 at given timesteps t (B,) f32 and
        packed noise eps (B, h·w/4, 4c): x_0 (B, h, w, c) latents are packed,
        noised to x_t = (1 − t)·x_0 + t·eps (detached, no gradient through
        it), and the flow runs with per-block recomputation by the `remat`
        policy ("block" or "dots", see models.flux.model.flux_forward)."""
        txt = t5_features
        txt_ids = torch.zeros((*txt.shape[:-1], 3), dtype=torch.int32, device=txt.device)
        x_ids = latent_ids(*x_0.shape[:3], device=x_0.device)
        x_0 = pack_latents(x_0)
        x_t = sampler_mod.add_noise(x_0, t, eps).detach()
        pred = flux_forward(
            flow_params, self.flow_cfg, img=x_t, img_ids=x_ids, txt=txt, txt_ids=txt_ids,
            timesteps=t.to(self.dtype), y=clip_features,
            guidance=guidance if self.flow_cfg.guidance_embed else None, remat=remat,
        )
        return torch.mean((pred + x_0 - eps).float() ** 2)
