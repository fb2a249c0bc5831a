"""Model configurations (the numbers of flux_generator_tpu/io/registry.py:31-93
for the Flux family and of the MusicGen-medium stack, over the port's own
config classes; that module imports the JAX model modules, so it is not
imported here). Nothing is downloaded: the names below are the public
sources of the numbers."""

from __future__ import annotations

from ..models.clip.text import CLIPTextConfig
from ..models.flux.autoencoder import AutoEncoderConfig
from ..models.flux.model import FluxConfig
from ..models.musicgen.encodec import EncodecConfig
from ..models.musicgen.model import MusicGenConfig
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
