"""Model configurations of the Flux family (the numbers of
flux_generator_tpu/io/registry.py:31-93, over the port's own config classes;
that module imports the JAX model modules, so it is not imported here)."""

from __future__ import annotations

from ..models.clip.text import CLIPTextConfig
from ..models.flux.autoencoder import AutoEncoderConfig
from ..models.flux.model import FluxConfig
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

FLUX_FLOW_CONFIGS = {
    "flux-dev": FluxConfig(guidance_embed=True, **_FLUX_BASE),
    "flux-schnell": FluxConfig(guidance_embed=False, **_FLUX_BASE),
}

# T5 token padding length per model
FLUX_T5_MAX_LENGTH = {"flux-dev": 512, "flux-schnell": 256}

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
    return FLUX_FLOW_CONFIGS[name], AutoEncoderConfig(), FLUX_CLIP_CONFIG, FLUX_T5_CONFIG
