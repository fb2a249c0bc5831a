"""Stable Diffusion 2.1 and SDXL-Turbo pipelines (counterpart of
flux_generator_tpu/pipelines/sd.py).

CLIP conditioning with a negative prompt, classifier-free guidance as a 2x
batch through the UNet then eps_neg + w·(eps_text − eps_neg), the Euler
(SD) or Euler-ancestral (SDXL) sampler, img2img from a strength-scaled
start time, and the VAE decode to clip(x/2 + 0.5, 0, 1), tiled above 128²
latents and one image at a time past one 1024² image (the encode tiled above
1024 px). SDXL conditions on the second to last hidden state of two CLIP
encoders, concatenated, with the second's pooled output and fixed
micro-conditioning time ids as its added embedding.

The device is the one the params lie on. Noise comes from a
`torch.Generator` seeded per request: one generator draws the prior (or
img2img's noise) and then each ancestral step's noise, where the JAX package
splits a key. PyTorch runs eagerly, so the JAX package's jitted step becomes
a plain loop; the schedule and the sigma table live on the device, so a
request queues its steps without a host synchronisation.

`w8a8` and `attn_int8` are the W8A8 serving configuration, as on
FluxPipeline: the JAX package's process-wide `set_w8a8(True)` (with
FGT_W8A8_IMPL) and `set_attn_int8`, here attributes of the pipeline passed
to every UNet and CLIP call (`w8a8` reaches their int8 per-channel dense
layers, `attn_int8` the UNet's self-attentions that take kernel A).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..io.params import tree_leaves
from ..models.clip.text import CLIPTextConfig, clip_text_forward, init_clip_text, tiny_clip_config
from ..models.sd import sampler as smp
from ..models.sd.config import (
    AutoencoderConfig,
    DiffusionConfig,
    UNetConfig,
    tiny_sd_ae_config,
    tiny_unet_config,
)
from ..models.sd.unet import init_unet, unet_forward
from ..models.sd.vae import init_sd_vae, sd_vae_decode, sd_vae_encode
from ..ops.tiling import batched_apply, tiled_decode_2d
from ..runtime.device import as_device, make_generator, synchronize, to_device

# SDXL's micro-conditioning: original size, crop offset, target size
# (flux_generator_tpu/pipelines/sd.py:432-435)
SDXL_TIME_IDS = (512.0, 512.0, 0.0, 0.0, 512.0, 512.0)


class StableDiffusion:
    """SD pipeline: one CLIP encoder, the Euler sampler."""

    ancestral = False
    default_model = "stabilityai/stable-diffusion-2-1-base"

    def __init__(self, model: str, params: dict, unet_cfg: UNetConfig, ae_cfg: AutoencoderConfig, clip_cfgs,
                 diffusion_cfg: DiffusionConfig = DiffusionConfig(), tokenizers=None, dtype=torch.bfloat16,
                 w8a8: Optional[str] = None, attn_int8: str = ""):
        self.model = model
        self.w8a8 = w8a8
        self.attn_int8 = attn_int8
        self.params = params
        self.unet_cfg = unet_cfg
        self.ae_cfg = ae_cfg
        self.clip_cfgs = list(clip_cfgs) if isinstance(clip_cfgs, (list, tuple)) else [clip_cfgs]
        self.diffusion_cfg = diffusion_cfg
        self.tokenizers = list(tokenizers) if isinstance(tokenizers, (list, tuple)) else [tokenizers]
        self.dtype = dtype
        self.sigmas = smp.make_sigmas(diffusion_cfg)
        self.sigma_table = to_device(self.sigmas, torch.float32, self.device)  # σ as f32 on the params' device

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params["unet"])[0].device

    # -------------------------------------------------- constructors

    @classmethod
    def _tiny_configs(cls):
        unet_cfg = tiny_unet_config()
        return unet_cfg, tiny_sd_ae_config(), [tiny_clip_config(model_dims=unet_cfg.cross_attention_dim[0])]

    @classmethod
    def random_init(cls, model: Optional[str] = None, tiny: bool = False, dtype=torch.bfloat16, device=None,
                    generator: Optional[torch.Generator] = None, w8a8: Optional[str] = None,
                    attn_int8: str = ""):
        """Randomly initialized pipeline on `device`, drawn from `generator`
        (seed 0 on `device` when None): the JAX package's tiny configs when
        `tiny`, else the full published configuration
        of `model` (io/registry.sd_configs; the class's own model when None).
        With neither device nor generator it builds on the current CUDA
        device, and raises where there is none."""
        from ..io.registry import sd_configs

        model = model or cls.default_model
        device = as_device(device if device is not None
                           else (generator.device if generator is not None else None))
        generator = generator if generator is not None else make_generator(device, 0)
        if tiny:
            unet_cfg, ae_cfg, clip_cfgs = cls._tiny_configs()
        else:
            unet_cfg, ae_cfg, clip_cfgs = sd_configs(model)
            if (len(clip_cfgs) == 2) != issubclass(cls, StableDiffusionXL):
                raise ValueError(f"{model} is not a {cls.__name__} model")
        params = {
            "unet": init_unet(generator, unet_cfg, dtype, device),
            "vae": init_sd_vae(generator, ae_cfg, dtype, device),
            "clip": init_clip_text(generator, clip_cfgs[0], dtype, device),
        }
        if len(clip_cfgs) > 1:
            params["clip_2"] = init_clip_text(generator, clip_cfgs[1], dtype, device)
        return cls(model, params, unet_cfg, ae_cfg, clip_cfgs, dtype=dtype, w8a8=w8a8, attn_int8=attn_int8)

    @classmethod
    def from_pretrained(cls, model: Optional[str] = None, dtype=torch.bfloat16, quantize: bool = False,
                        device=None, **kwargs):
        """The pipeline of a checkpoint (io/loaders.load_sd_pipeline): a
        diffusers repo in the local hub cache, or `local_dir=`; on `device`
        (the current CUDA device when None). `quantize` puts the UNet's and
        CLIP's dense layers in int8."""
        from ..io.loaders import load_sd_pipeline

        return load_sd_pipeline(model or cls.default_model, cls=cls, dtype=dtype, quantize=quantize,
                                device=device, **kwargs)

    # -------------------------------------------------- conditioning

    def _pad_rows(self, rows, tokenizer, cfg: Optional[CLIPTextConfig] = None) -> torch.Tensor:
        """Token rows padded with 0 to the model's fixed max_length, so the
        conditioning's length never depends on the prompt (nor, coalesced,
        on other users' prompts); longer rows are cut with EOS forced last
        (CLIP pools at the EOS position)."""
        n = (cfg or self.clip_cfgs[0]).max_length
        eos = getattr(tokenizer, "eos_token", None)
        out = []
        for r in rows:
            if len(r) > n:
                r = r[:n]
                if eos is not None:
                    r[-1] = eos
            out.append(r + [0] * (n - len(r)))
        return to_device(out, torch.long, self.device)

    def _tokenize(self, tokenizer, text: str, negative_text: Optional[str] = None, cfg=None) -> torch.Tensor:
        rows = [tokenizer.tokenize(text)]
        if negative_text is not None:
            rows.append(tokenizer.tokenize(negative_text))
        return self._pad_rows(rows, tokenizer, cfg)

    def _text_encode(self, clip_params, tokens):
        return clip_text_forward(clip_params, self.clip_cfgs[0], tokens, self.w8a8)["last_hidden_state"]

    def get_text_conditioning(self, text, n_images=1, cfg_weight=7.5, negative_text=""):
        """(rows, 77, context) in the working dtype: the prompt's rows, then
        the negative prompt's under CFG (cfg_weight > 1), each n_images
        times."""
        tokens = self._tokenize(self.tokenizers[0], text, negative_text if cfg_weight > 1 else None)
        conditioning = self._text_encode(self.params["clip"], tokens).to(self.dtype)
        if n_images > 1:
            conditioning = conditioning.repeat_interleave(n_images, dim=0)
        return conditioning

    def _text_time_for(self, conditioning, n_images):
        return None

    # -------------------------------------------------- denoising

    def _eps(self, x_t, t, conditioning, cfg_weight, cfg_on, text_time):
        x_in = torch.cat([x_t, x_t]) if cfg_on else x_t
        t_in = t.expand(x_in.shape[0])
        eps = unet_forward(self.params["unet"], self.unet_cfg, x_in, t_in, conditioning, text_time=text_time,
                           w8a8=self.w8a8, attn_int8=self.attn_int8)
        if cfg_on:
            eps_text, eps_neg = eps.chunk(2)
            # the weight rounded to eps's dtype first, as the JAX package casts it
            w = float(torch.tensor(cfg_weight, dtype=torch.float32).to(eps.dtype))
            eps = eps_neg + w * (eps_text - eps_neg)
        return eps

    def _step(self, x_t, t, t_prev, conditioning, cfg_weight, generator, cfg_on, text_time=None):
        """One sampler step from t to t_prev (f32 tensors on the device); the
        ancestral step draws its noise from `generator`."""
        eps = self._eps(x_t, t, conditioning, cfg_weight, cfg_on, text_time)
        sigmas = self.sigma_table
        if self.ancestral:
            noise = smp.normal(generator, x_t.shape, x_t.dtype)
            return smp.euler_ancestral_step(noise, sigmas, eps, x_t, t, t_prev)
        return smp.euler_step(sigmas, eps, x_t, t, t_prev)

    def _steps(self, x_t, ts, conditioning, cfg_weight, generator, text_time):
        """Steps over the schedule ts (num_steps + 1,), yielding each latent."""
        cfg_on = cfg_weight > 1
        ts = to_device(ts, torch.float32, x_t.device)
        for i in range(ts.shape[0] - 1):
            x_t = self._step(x_t, ts[i], ts[i + 1], conditioning, cfg_weight, generator, cfg_on, text_time)
            yield x_t

    def denoise(self, x_T, conditioning, num_steps, cfg_weight, generator: Optional[torch.Generator] = None,
                start_time=None, text_time=None):
        """The whole schedule from x_T → the final latent; the ancestral
        steps draw from `generator`."""
        x = x_T
        for x in self._steps(x_T, smp.timesteps(self.sigmas, num_steps, start_time), conditioning, cfg_weight,
                             generator, text_time):
            pass
        return x

    # -------------------------------------------------- generation (the JAX package's API)

    def _split_conditioning(self, conditioning, n_images):
        """(UNet context, text_time) of get_text_conditioning's result."""
        text_time = self._text_time_for(conditioning, n_images)
        return (conditioning[0] if text_time is not None else conditioning), text_time

    @staticmethod
    def _mark(trace, key, t0, device):
        """Record the seconds since t0 under `key` after a device
        synchronize, when a trace dict is given."""
        if trace is not None:
            synchronize(device)
            trace[key] = time.perf_counter() - t0

    def generate_latents(self, text: str, n_images: int = 1, num_steps: int = 50, cfg_weight: float = 7.5,
                         negative_text: str = "", latent_size: Tuple[int, int] = (64, 64), seed=None,
                         trace: Optional[dict] = None):
        """Yields the latent (n_images, h, w, 4) after each of num_steps
        steps. `trace`, when a dict is given, receives "conditioning_s" (the
        text encoders and the prior, ended by a device synchronize)."""
        t0 = time.perf_counter()
        device = self.device
        generator = make_generator(device, np.random.randint(1 << 31) if seed is None else seed)
        conditioning, text_time = self._split_conditioning(
            self.get_text_conditioning(text, n_images, cfg_weight, negative_text), n_images)
        x_t = smp.sample_prior(generator, self.sigmas, (n_images, *latent_size, self.ae_cfg.latent_channels_in),
                               self.dtype)
        self._mark(trace, "conditioning_s", t0, device)
        yield from self._steps(x_t, smp.timesteps(self.sigmas, num_steps), conditioning, cfg_weight, generator,
                               text_time)

    # ------------------------------------------- batched multi-prompt path

    def _batch_tokens(self, tokenizer, texts, negative_text, cfg_on, cfg=None) -> torch.Tensor:
        """The texts' rows, then the negative prompt's (one for each text)
        under CFG: the layout _eps splits (eps_text | eps_neg)."""
        rows = [tokenizer.tokenize(t) for t in texts]
        if cfg_on:
            rows += [tokenizer.tokenize(negative_text)] * len(texts)
        return self._pad_rows(rows, tokenizer, cfg)

    def _batch_conditioning(self, texts, cfg_weight, negative_text):
        tokens = self._batch_tokens(self.tokenizers[0], texts, negative_text, cfg_weight > 1)
        return self._text_encode(self.params["clip"], tokens).to(self.dtype)

    def generate_latents_batch(self, texts, seeds, num_steps: int = 50, cfg_weight: float = 7.5,
                               negative_text: str = "", latent_size: Tuple[int, int] = (64, 64),
                               trace: Optional[dict] = None):
        """Several prompts, one seed each, denoised as one batch (the
        server's coalescer drives this): yields the (n, h, w, 4) latent after
        each step. Each prior is the first draw of its seed's generator, as
        in generate_latents, so an Euler (SD) item equals its seed's solo
        run; the ancestral noise comes from one generator for the batch,
        seeded seeds[0] ^ 0x5EED. `trace` as in generate_latents."""
        if len(texts) != len(seeds):
            raise ValueError(f"{len(texts)} texts but {len(seeds)} seeds")
        t0 = time.perf_counter()
        device = self.device
        n = len(texts)
        conditioning, text_time = self._split_conditioning(
            self._batch_conditioning(texts, cfg_weight, negative_text), n)
        shape = (1, *latent_size, self.ae_cfg.latent_channels_in)
        x_t = torch.cat([smp.sample_prior(make_generator(device, 0 if s is None else int(s)), self.sigmas, shape,
                                          self.dtype) for s in seeds])
        generator = make_generator(device, 0 if seeds[0] is None else int(seeds[0]) ^ 0x5EED)
        self._mark(trace, "conditioning_s", t0, device)
        yield from self._steps(x_t, smp.timesteps(self.sigmas, num_steps), conditioning, cfg_weight, generator,
                               text_time)

    def generate_latents_from_image(self, image, text: str, n_images: int = 1, strength: float = 0.8,
                                    num_steps: int = 50, cfg_weight: float = 7.5, negative_text: str = "",
                                    seed=None, trace: Optional[dict] = None):
        """img2img: the image (H, W, 3) in about [-1, 1] encoded, noised to
        time max_time · strength, then int(num_steps · strength) steps from
        there; yields each latent. `trace`, when a dict is given, receives
        "conditioning_s" (the text encoders) and "encode_s" (the VAE encode
        and the noise), each ended by a device synchronize."""
        t0 = time.perf_counter()
        device = self.device
        generator = make_generator(device, np.random.randint(1 << 31) if seed is None else seed)
        start_time = smp.max_time(self.sigmas) * strength
        num_steps = int(num_steps * strength)
        conditioning, text_time = self._split_conditioning(
            self.get_text_conditioning(text, n_images, cfg_weight, negative_text), n_images)
        self._mark(trace, "conditioning_s", t0, device)
        t0 = time.perf_counter()
        img = to_device(image, self.dtype, device)
        x_0 = self._encode(img[None] if img.dim() == 3 else img)
        x_0 = x_0.expand(n_images, *x_0.shape[1:])
        noise = smp.normal(generator, x_0.shape, x_0.dtype)
        x_t = smp.add_noise(noise, self.sigma_table, x_0, start_time)
        self._mark(trace, "encode_s", t0, device)
        yield from self._steps(x_t, smp.timesteps(self.sigmas, num_steps, start_time=start_time), conditioning,
                               cfg_weight, generator, text_time)

    # -------------------------------------------------- VAE

    def _factor(self) -> int:
        return 2 ** (len(self.ae_cfg.block_out_channels) - 1)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, 3) → latent means, one image at a time past one
        1024² image's pixels, in overlapping 768² tiles (overlap 128) above
        1024 px on either side."""
        params, cfg = self.params["vae"], self.ae_cfg

        def one(xi):
            if max(xi.shape[1], xi.shape[2]) > 1024:
                return tiled_decode_2d(lambda xt: sd_vae_encode(params, cfg, xt)[0], xi, tile=768, overlap=128,
                                       factor=1 / self._factor())
            return sd_vae_encode(params, cfg, xi)[0]

        return batched_apply(one, x, pixel_limit=1024 * 1024)

    def _decode(self, z: torch.Tensor, as_uint8: bool) -> torch.Tensor:
        """Latents → images in [0, 1] (or uint8), one image at a time past
        one 1024² image's latents, each in overlapping 96² tiles (overlap 16)
        above 128² latents."""
        params, cfg = self.params["vae"], self.ae_cfg

        def one(zi):
            if max(zi.shape[1], zi.shape[2]) > 128:
                return tiled_decode_2d(lambda zt: sd_vae_decode(params, cfg, zt), zi, tile=96, overlap=16,
                                       factor=self._factor())
            return sd_vae_decode(params, cfg, zi)

        img = torch.clamp(batched_apply(one, z, pixel_limit=128 * 128) / 2 + 0.5, 0, 1)
        if as_uint8:
            img = (img.float() * 255).to(torch.uint8)
        return img

    def decode(self, x_t):
        return self._decode(x_t, as_uint8=False)

    def decode_u8(self, x_t):
        """Decode straight to uint8 RGB on the device (the serving path)."""
        return self._decode(x_t, as_uint8=True)


class StableDiffusionXL(StableDiffusion):
    """SDXL(-Turbo): two CLIP encoders, text_time micro-conditioning, the
    Euler-ancestral sampler; generate_latents and its img2img take 2 steps
    without CFG by default (generate_latents_batch keeps the base class's
    defaults, as in the JAX package)."""

    ancestral = True
    default_model = "stabilityai/sdxl-turbo"

    @classmethod
    def _tiny_configs(cls):
        clip1 = tiny_clip_config(model_dims=8)
        clip2 = tiny_clip_config(model_dims=8, projection_dim=8)
        unet_cfg = tiny_unet_config(cross_attention_dim=(16, 16), addition_embed_type="text_time",
                                    addition_time_embed_dim=8, projection_class_embeddings_input_dim=8 + 6 * 8)
        return unet_cfg, tiny_sd_ae_config(), [clip1, clip2]

    def _encode_both(self, toks1, toks2):
        out1 = clip_text_forward(self.params["clip"], self.clip_cfgs[0], toks1, self.w8a8)
        out2 = clip_text_forward(self.params["clip_2"], self.clip_cfgs[1], toks2, self.w8a8)
        conditioning = torch.cat([out1["hidden_states"][-2], out2["hidden_states"][-2]], dim=-1).to(self.dtype)
        return conditioning, out2["pooled_output"].to(self.dtype)

    def _tokenizer_2(self):
        return self.tokenizers[1] if len(self.tokenizers) > 1 else self.tokenizers[0]

    def get_text_conditioning(self, text, n_images=1, cfg_weight=7.5, negative_text=""):
        """(conditioning (rows, 77, 2048), pooled (rows, 1280)), rows as in
        StableDiffusion.get_text_conditioning."""
        neg = negative_text if cfg_weight > 1 else None
        toks1 = self._tokenize(self.tokenizers[0], text, neg, cfg=self.clip_cfgs[0])
        toks2 = self._tokenize(self._tokenizer_2(), text, neg, cfg=self.clip_cfgs[1])
        conditioning, pooled = self._encode_both(toks1, toks2)
        if n_images > 1:
            conditioning = conditioning.repeat_interleave(n_images, dim=0)
            pooled = pooled.repeat_interleave(n_images, dim=0)
        return conditioning, pooled

    def _batch_conditioning(self, texts, cfg_weight, negative_text):
        cfg_on = cfg_weight > 1
        toks1 = self._batch_tokens(self.tokenizers[0], texts, negative_text, cfg_on, cfg=self.clip_cfgs[0])
        toks2 = self._batch_tokens(self._tokenizer_2(), texts, negative_text, cfg_on, cfg=self.clip_cfgs[1])
        return self._encode_both(toks1, toks2)

    def _text_time_for(self, conditioning, n_images):
        pooled = conditioning[1]
        time_ids = to_device([SDXL_TIME_IDS] * pooled.shape[0], torch.float32, pooled.device)
        return pooled, time_ids

    def generate_latents(self, text, n_images=1, num_steps=2, cfg_weight=0.0, negative_text="",
                         latent_size=(64, 64), seed=None, trace=None):
        yield from super().generate_latents(text, n_images, num_steps, cfg_weight, negative_text, latent_size,
                                            seed, trace)

    def generate_latents_from_image(self, image, text, n_images=1, strength=0.8, num_steps=2, cfg_weight=0.0,
                                    negative_text="", seed=None, trace=None):
        yield from super().generate_latents_from_image(image, text, n_images, strength, num_steps, cfg_weight,
                                                       negative_text, seed, trace)
