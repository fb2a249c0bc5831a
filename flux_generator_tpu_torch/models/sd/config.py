"""SD / SDXL config dataclasses (counterpart of
flux_generator_tpu/models/sd/config.py: the same fields, defaults and
per-level meaning).

`up_block_types` is read by level (index 0 the shallowest), as
`unet.init_unet` reads every per-level field. The default is Hugging Face's
deepest-first list as it stands in the JAX package, so read by level it puts
the up path's cross-attention at levels 1-3; a loaded SD 2.1-base has it at
levels 0-2 (io/registry.py builds that).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels_out: int = 8
    latent_channels_in: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: Sequence[int] = (2, 2, 2, 2)
    transformer_layers_per_block: Sequence[int] = (1, 1, 1, 1)
    num_attention_heads: Sequence[int] = (5, 10, 20, 20)
    cross_attention_dim: Sequence[int] = (1024, 1024, 1024, 1024)
    norm_num_groups: int = 32
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    addition_embed_type: Optional[str] = None  # "text_time" for SDXL
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None

    @property
    def temb_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    beta_schedule: str = "scaled_linear"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_train_steps: int = 1000


def tiny_unet_config(**overrides) -> UNetConfig:
    base = dict(
        block_out_channels=(8, 16),
        layers_per_block=(1, 1),
        transformer_layers_per_block=(1, 1),
        num_attention_heads=(2, 2),
        cross_attention_dim=(16, 16),
        norm_num_groups=4,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    )
    base.update(overrides)
    return UNetConfig(**base)


def tiny_sd_ae_config(**overrides) -> AutoencoderConfig:
    base = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
    base.update(overrides)
    return AutoencoderConfig(**base)
