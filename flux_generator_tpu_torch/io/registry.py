"""Model configurations and checkpoint locations (the numbers and file
names of flux_generator_tpu/io/registry.py for the Flux family, of the
MusicGen-medium stack and of SD 2.1-base and SDXL-Turbo, over the port's own
config classes; that module imports the JAX model modules, so it is not
imported here). Nothing is downloaded: the repo ids name where each
checkpoint is published, and io/loaders reads them from a local directory or
the local Hugging Face hub cache. The FLUX_DEV / FLUX_SCHNELL / AE
environment variables name a checkpoint file in place of the registry's."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ..models.clip.text import CLIPTextConfig
from ..models.flux.autoencoder import AutoEncoderConfig
from ..models.flux.model import FluxConfig
from ..models.musicgen.encodec import EncodecConfig
from ..models.musicgen.model import MusicGenConfig
from ..models.sd.config import AutoencoderConfig, UNetConfig
from ..models.t5.t5 import T5Config

_FLUX_BASE = dict(
    in_channels=64,
    vec_in_dim=768,
    context_in_dim=4096,
    hidden_size=3072,
    mlp_ratio=4.0,
    num_heads=24,
    depth=19,
    depth_single_blocks=38,
    axes_dim=(16, 56, 56),
    theta=10_000,
    qkv_bias=True,
)



@dataclasses.dataclass(frozen=True)
class FluxModelSpec:
    repo_id: str
    repo_flow: str  # the flow's file in the repo
    repo_ae: str  # the autoencoder's
    ckpt_env: Optional[str]  # environment variable naming a flow file in its place
    flow: FluxConfig
    ae: AutoEncoderConfig
    t5_max_length: int  # T5 token padding length


FLUX_MODELS = {
    "flux-dev": FluxModelSpec(
        repo_id="black-forest-labs/FLUX.1-dev", repo_flow="flux1-dev.safetensors", repo_ae="ae.safetensors",
        ckpt_env="FLUX_DEV", flow=FluxConfig(guidance_embed=True, **_FLUX_BASE), ae=AutoEncoderConfig(),
        t5_max_length=512),
    "flux-schnell": FluxModelSpec(
        repo_id="black-forest-labs/FLUX.1-schnell", repo_flow="flux1-schnell.safetensors",
        repo_ae="ae.safetensors", ckpt_env="FLUX_SCHNELL", flow=FluxConfig(guidance_embed=False, **_FLUX_BASE),
        ae=AutoEncoderConfig(), t5_max_length=256),
}
FLUX_T5_MAX_LENGTH = {name: spec.t5_max_length for name, spec in FLUX_MODELS.items()}

# CLIP-L and T5-XXL as used by Flux
FLUX_CLIP_CONFIG = CLIPTextConfig(
    num_layers=12, model_dims=768, num_heads=12, max_length=77, vocab_size=49408,
    hidden_act="quick_gelu",
)
FLUX_T5_CONFIG = T5Config(
    vocab_size=32128,
    num_layers=24,
    num_heads=64,
    relative_attention_num_buckets=32,
    d_kv=64,
    d_model=4096,
    feed_forward_proj="gated-gelu",
    tie_word_embeddings=False,
    d_ff=10240,
)


def flux_configs(name: str):
    """(flow, autoencoder, CLIP, T5) configs of a Flux model name."""
    spec = FLUX_MODELS[name]
    return spec.flow, spec.ae, FLUX_CLIP_CONFIG, FLUX_T5_CONFIG


def flux_ckpt_override(name: str) -> Optional[str]:
    """The flow file named by the model's environment variable, if set."""
    env = FLUX_MODELS[name].ckpt_env
    return os.getenv(env) if env else None


def ae_ckpt_override() -> Optional[str]:
    return os.getenv("AE")


# MusicGen-medium (facebook/musicgen-medium): 48 decoder layers, hidden 1536,
# 24 heads of 64, ffn 6144, 4 codebooks of 2048 — the MusicGenConfig defaults
# of flux_generator_tpu/models/musicgen/model.py:37-51.
MUSICGEN_REPO = "facebook/musicgen-medium"
MUSICGEN_MEDIUM_CONFIG = MusicGenConfig()

# its text encoder, T5-base (bench.py:671-673): relu FFN, tied embeddings
MUSICGEN_T5_CONFIG = T5Config(num_layers=12, num_heads=12, d_kv=64, d_model=768, d_ff=3072,
                              feed_forward_proj="relu", tie_word_embeddings=True)

# its audio codec, the EnCodec 32 kHz conversion (mlx-community/encodec-32khz-float32):
# 64 filters, ratios (8, 5, 4, 4), 2 LSTM layers, hidden 128, 2048 codes
ENCODEC_REPO = "mlx-community/encodec-32khz-float32"
ENCODEC_32KHZ_CONFIG = EncodecConfig()


def musicgen_configs():
    """(decoder, T5, EnCodec) configs of MusicGen-medium."""
    return MUSICGEN_MEDIUM_CONFIG, MUSICGEN_T5_CONFIG, ENCODEC_32KHZ_CONFIG


# SD 2.1-base and SDXL-Turbo, as flux_generator_tpu/io/loaders.py:246-320
# builds them from each repo's unet/, vae/, text_encoder/ (and
# text_encoder_2/) config.json: Hugging Face's `attention_head_dim` list is
# the heads a level (heads of 64 everywhere), `layers_per_block` and a scalar
# `cross_attention_dim` repeat over the levels, and `up_block_types` is
# reversed from HF's deepest-first order into ours, by level.
SD_MODELS = {
    "sdxl-turbo": {"repo_id": "stabilityai/sdxl-turbo"},
    "stable-diffusion-2-1-base": {"repo_id": "stabilityai/stable-diffusion-2-1-base"},
}

# stabilityai/stable-diffusion-2-1-base unet/config.json: cross-attention at
# levels 0-2 on both paths. bench.py:49 times `UNetConfig()` as "SD 2.1-base
# geometry", whose default up_block_types (HF's list unreversed) put the up
# path's cross-attention at levels 1-3: at 512² none at 64x64 and three sites
# at 8x8, so 12 self-attentions reach the flash kernel a UNet call there, 15
# in the loaded model.
SD21_UNET_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280, 1280),
    layers_per_block=(2, 2, 2, 2),
    transformer_layers_per_block=(1, 1, 1, 1),
    num_attention_heads=(5, 10, 20, 20),
    cross_attention_dim=(1024, 1024, 1024, 1024),
    norm_num_groups=32,
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
)
# its vae/config.json (block_out_channels 128-512, 4 latent channels)
SD21_VAE_CONFIG = AutoencoderConfig(scaling_factor=0.18215)
# its text_encoder/config.json: OpenCLIP ViT-H's text tower less its last
# layer, exact gelu
SD21_CLIP_CONFIG = CLIPTextConfig(num_layers=23, model_dims=1024, num_heads=16, max_length=77,
                                  vocab_size=49408, hidden_act="gelu")

# stabilityai/sdxl-turbo unet/config.json: three levels, no attention at
# level 0, 2 and 10 transformer blocks a site at levels 1 and 2 (10 in the
# mid block), context 2048 = 768 + 1280, the text_time added embedding over
# the pooled 1280 and six time ids of 256 (2816 inputs)
SDXL_UNET_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280),
    layers_per_block=(2, 2, 2),
    transformer_layers_per_block=(1, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=(2048, 2048, 2048),
    norm_num_groups=32,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)
# its vae/config.json: SD's geometry with scaling_factor 0.13025
SDXL_VAE_CONFIG = AutoencoderConfig(scaling_factor=0.13025)
# its text_encoder/config.json (CLIP ViT-L) and text_encoder_2/config.json
# (OpenCLIP bigG, whose pooled output goes through text_projection)
SDXL_CLIP_CONFIGS = (
    CLIPTextConfig(num_layers=12, model_dims=768, num_heads=12, max_length=77, vocab_size=49408,
                   hidden_act="quick_gelu"),
    CLIPTextConfig(num_layers=32, model_dims=1280, num_heads=20, max_length=77, vocab_size=49408,
                   hidden_act="gelu", projection_dim=1280),
)

_SD_CONFIGS = {
    "stable-diffusion-2-1-base": (SD21_UNET_CONFIG, SD21_VAE_CONFIG, (SD21_CLIP_CONFIG,)),
    "sdxl-turbo": (SDXL_UNET_CONFIG, SDXL_VAE_CONFIG, SDXL_CLIP_CONFIGS),
}


def sd_model_key(name: str) -> str:
    """The SD_MODELS key of a model name or repo id."""
    for key, spec in SD_MODELS.items():
        if name in (key, spec["repo_id"]):
            return key
    raise KeyError(f"unknown SD model {name!r}; known: {sorted(SD_MODELS)}")


def sd_configs(name: str):
    """(UNet, VAE, (CLIP, ...)) configs of an SD model name or repo id."""
    return _SD_CONFIGS[sd_model_key(name)]
