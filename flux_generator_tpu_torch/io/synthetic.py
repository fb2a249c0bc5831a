"""Synthetic checkpoint caches in the published on-disk formats (the port's
counterpart of flux_generator_tpu/io/synthetic.py), written without
`transformers` or `safetensors`.

Each `*_state` function describes a checkpoint as {name: Lazy(shape,
dtype, make)} under the key names and shapes the publishers use — BFL's
flow and autoencoder, Hugging Face's CLIPTextModel(WithProjection),
T5EncoderModel, T5ForConditionalGeneration and EncodecModel, audiocraft's
MusicGen `best_state`, diffusers' UNet2DConditionModel and AutoencoderKL —
with the `config.json` bodies those libraries write.
io/safetensors.save_safetensors then makes, writes and frees one tensor at
a time, so a full-width cache (Flux-schnell's is 34 GB in bf16) never sits
whole in host memory.

Values are random, never zero: each tensor is drawn from its own
torch.Generator on `device`, seeded by (seed, name), so a file does not
depend on the order it is written in and tied names (T5's shared
embedding) hold equal values. Weights are N(0, 0.02²); norm scales
1 + N(0, 0.02²); EnCodec's weight-norm magnitudes U(0.5, 1.5), its LSTM
U(±1/√d) as torch initializes it, and its codebooks N(0, 1).

`make_*_cache` writes a whole repository: into `root` as a local directory
(the layout `from_pretrained(local_dir=...)` reads), or with `hub=True`
under `root` as a Hugging Face hub cache, models--{org}--{name}/refs/main
naming snapshots/<commit>/, which io/loaders.hf_snapshot resolves when
HF_HUB_CACHE is `root`. Configs default to the JAX package's tiny ones; the
published ones come from io/registry.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import zlib
from pathlib import Path
from typing import Optional

import torch

from ..runtime.device import as_device
from . import registry
from .safetensors import Lazy, save_safetensors, save_sharded_safetensors

# ------------------------------------------------------------ drawing


class Draw:
    """Lazy random tensors of one checkpoint: `dtype` on `device` (the
    current CUDA device when None), each from a generator seeded by (seed,
    name)."""

    def __init__(self, seed: int = 0, dtype=torch.float32, device=None):
        self.seed, self.dtype, self.device = seed, dtype, as_device(device)

    def _gen(self, name: str) -> torch.Generator:
        # 32 bits: the CPU generator (mt19937) takes no more
        return torch.Generator(self.device).manual_seed(zlib.crc32(f"{self.seed}/{name}".encode()))

    def normal(self, name: str, shape, std: float = 0.02, mean: float = 0.0) -> Lazy:
        def make():
            x = torch.randn(shape, generator=self._gen(name), device=self.device, dtype=torch.float32)
            return (x * std + mean).to(self.dtype)

        return Lazy(tuple(shape), self.dtype, make)

    def uniform(self, name: str, shape, low: float, high: float) -> Lazy:
        def make():
            u = torch.rand(shape, generator=self._gen(name), device=self.device, dtype=torch.float32)
            return (low + u * (high - low)).to(self.dtype)

        return Lazy(tuple(shape), self.dtype, make)

    def weight(self, name: str, *shape) -> Lazy:
        return self.normal(name, shape)

    def scale(self, name: str, *shape) -> Lazy:
        return self.normal(name, shape, mean=1.0)


# ------------------------------------------------------------ flux (BFL keys)


def bfl_flux_state(cfg, draw: Draw) -> dict:
    """BFL flux1-*.safetensors key layout."""
    h, mlp, hd = cfg.hidden_size, cfg.mlp_hidden, cfg.head_dim
    out = {}

    def w(name, *shape):
        out[name] = draw.weight(name, *shape)

    def s(name, *shape):
        out[name] = draw.scale(name, *shape)

    w("img_in.weight", h, cfg.in_channels)
    w("img_in.bias", h)
    w("txt_in.weight", h, cfg.context_in_dim)
    w("txt_in.bias", h)
    mlps = [("time_in", 256), ("vector_in", cfg.vec_in_dim)]
    if cfg.guidance_embed:
        mlps.append(("guidance_in", 256))
    for name, din in mlps:
        w(f"{name}.in_layer.weight", h, din)
        w(f"{name}.in_layer.bias", h)
        w(f"{name}.out_layer.weight", h, h)
        w(f"{name}.out_layer.bias", h)
    for i in range(cfg.depth):
        p = f"double_blocks.{i}"
        for side in ("img", "txt"):
            w(f"{p}.{side}_mod.lin.weight", 6 * h, h)
            w(f"{p}.{side}_mod.lin.bias", 6 * h)
            w(f"{p}.{side}_attn.qkv.weight", 3 * h, h)
            w(f"{p}.{side}_attn.qkv.bias", 3 * h)
            s(f"{p}.{side}_attn.norm.query_norm.scale", hd)
            s(f"{p}.{side}_attn.norm.key_norm.scale", hd)
            w(f"{p}.{side}_attn.proj.weight", h, h)
            w(f"{p}.{side}_attn.proj.bias", h)
            w(f"{p}.{side}_mlp.0.weight", mlp, h)
            w(f"{p}.{side}_mlp.0.bias", mlp)
            w(f"{p}.{side}_mlp.2.weight", h, mlp)
            w(f"{p}.{side}_mlp.2.bias", h)
    for i in range(cfg.depth_single_blocks):
        p = f"single_blocks.{i}"
        w(f"{p}.linear1.weight", 3 * h + mlp, h)
        w(f"{p}.linear1.bias", 3 * h + mlp)
        w(f"{p}.linear2.weight", h, h + mlp)
        w(f"{p}.linear2.bias", h)
        s(f"{p}.norm.query_norm.scale", hd)
        s(f"{p}.norm.key_norm.scale", hd)
        w(f"{p}.modulation.lin.weight", 3 * h, h)
        w(f"{p}.modulation.lin.bias", 3 * h)
    w("final_layer.linear.weight", cfg.in_channels, h)
    w("final_layer.linear.bias", cfg.in_channels)
    w("final_layer.adaLN_modulation.1.weight", 2 * h, h)
    w("final_layer.adaLN_modulation.1.bias", 2 * h)
    return out


class _ConvState:
    """Key writers shared by the image autoencoders and the UNet."""

    def __init__(self, draw: Draw):
        self.draw, self.out = draw, {}

    def gn(self, prefix, c):
        self.out[f"{prefix}.weight"] = self.draw.scale(f"{prefix}.weight", c)
        self.out[f"{prefix}.bias"] = self.draw.weight(f"{prefix}.bias", c)

    def lin(self, prefix, din, dout, bias=True):
        self.out[f"{prefix}.weight"] = self.draw.weight(f"{prefix}.weight", dout, din)
        if bias:
            self.out[f"{prefix}.bias"] = self.draw.weight(f"{prefix}.bias", dout)

    def conv(self, prefix, cin, cout, k=3):
        self.out[f"{prefix}.weight"] = self.draw.weight(f"{prefix}.weight", cout, cin, k, k)
        self.out[f"{prefix}.bias"] = self.draw.weight(f"{prefix}.bias", cout)


def bfl_flux_ae_state(cfg, draw: Draw) -> dict:
    """BFL ae.safetensors key layout: torchvision names, OIHW convs, 1×1-conv
    attention projections."""
    st = _ConvState(draw)

    def resnet(prefix, cin, cout):
        st.gn(f"{prefix}.norm1", cin)
        st.conv(f"{prefix}.conv1", cin, cout)
        st.gn(f"{prefix}.norm2", cout)
        st.conv(f"{prefix}.conv2", cout, cout)
        if cin != cout:
            st.conv(f"{prefix}.nin_shortcut", cin, cout, 1)

    def attn(prefix, c):
        st.gn(f"{prefix}.norm", c)
        for name in ("q", "k", "v", "proj_out"):
            st.conv(f"{prefix}.{name}", c, c, 1)

    n = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    st.conv("encoder.conv_in", cfg.in_channels, cfg.ch)
    block_in = cfg.ch
    for i in range(n):
        block_in = cfg.ch * in_mult[i]
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            resnet(f"encoder.down.{i}.block.{j}", block_in, block_out)
            block_in = block_out
        if i != n - 1:
            st.conv(f"encoder.down.{i}.downsample.conv", block_in, block_in)
    resnet("encoder.mid.block_1", block_in, block_in)
    attn("encoder.mid.attn_1", block_in)
    resnet("encoder.mid.block_2", block_in, block_in)
    st.gn("encoder.norm_out", block_in)
    st.conv("encoder.conv_out", block_in, 2 * cfg.z_channels)

    block_in = cfg.ch * cfg.ch_mult[-1]
    st.conv("decoder.conv_in", cfg.z_channels, block_in)
    resnet("decoder.mid.block_1", block_in, block_in)
    attn("decoder.mid.attn_1", block_in)
    resnet("decoder.mid.block_2", block_in, block_in)
    for i in reversed(range(n)):
        block_out = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            resnet(f"decoder.up.{i}.block.{j}", block_in, block_out)
            block_in = block_out
        if i != 0:
            st.conv(f"decoder.up.{i}.upsample.conv", block_in, block_in)
    st.gn("decoder.norm_out", block_in)
    st.conv("decoder.conv_out", block_in, cfg.out_ch)
    return st.out


# ------------------------------------------------ Hugging Face text models


def hf_clip_state(cfg, draw: Draw) -> tuple:
    """transformers CLIPTextModel keys (CLIPTextModelWithProjection's when
    cfg.projection_dim is set) and its config.json body."""
    st = _ConvState(draw)
    d, p = cfg.model_dims, "text_model"
    st.out[f"{p}.embeddings.token_embedding.weight"] = draw.weight(
        f"{p}.embeddings.token_embedding.weight", cfg.vocab_size, d)
    st.out[f"{p}.embeddings.position_embedding.weight"] = draw.weight(
        f"{p}.embeddings.position_embedding.weight", cfg.max_length, d)
    for i in range(cfg.num_layers):
        layer = f"{p}.encoder.layers.{i}"
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            st.lin(f"{layer}.self_attn.{proj}", d, d)
        st.gn(f"{layer}.layer_norm1", d)
        st.lin(f"{layer}.mlp.fc1", d, 4 * d)
        st.lin(f"{layer}.mlp.fc2", 4 * d, d)
        st.gn(f"{layer}.layer_norm2", d)
    st.gn(f"{p}.final_layer_norm", d)
    if cfg.projection_dim:
        st.lin("text_projection", d, cfg.projection_dim, bias=False)
    body = {
        "attention_dropout": 0.0, "bos_token_id": 0, "eos_token_id": cfg.vocab_size - 1,
        "hidden_act": cfg.hidden_act, "hidden_size": d, "initializer_factor": 1.0,
        "initializer_range": 0.02, "intermediate_size": 4 * d, "layer_norm_eps": 1e-05,
        "max_position_embeddings": cfg.max_length, "model_type": "clip_text_model",
        "num_attention_heads": cfg.num_heads, "num_hidden_layers": cfg.num_layers, "pad_token_id": 1,
        "projection_dim": cfg.projection_dim or d, "vocab_size": cfg.vocab_size,
    }
    return st.out, body


def t5_config_body(cfg, decoder: bool) -> dict:
    """The config.json body transformers writes for a T5EncoderModel
    (decoder=False) or a T5ForConditionalGeneration of `cfg`."""
    act = cfg.feed_forward_proj.split("-")[-1]
    body = {
        "classifier_dropout": 0.0, "d_ff": cfg.d_ff, "d_kv": cfg.d_kv, "d_model": cfg.d_model,
        "dense_act_fn": "gelu_new" if act == "gelu" else act, "dropout_rate": 0.0, "eos_token_id": 1,
        "feed_forward_proj": cfg.feed_forward_proj, "initializer_factor": 1.0,
        "is_encoder_decoder": decoder, "is_gated_act": cfg.feed_forward_proj.startswith("gated"),
        "layer_norm_epsilon": cfg.layer_norm_epsilon, "model_type": "t5",
        "num_decoder_layers": cfg.num_decoder_layers or cfg.num_layers, "num_heads": cfg.num_heads,
        "num_layers": cfg.num_layers, "pad_token_id": 0,
        "relative_attention_max_distance": cfg.relative_attention_max_distance,
        "relative_attention_num_buckets": cfg.relative_attention_num_buckets, "use_cache": decoder,
        "vocab_size": cfg.vocab_size,
    }
    if not cfg.tie_word_embeddings:
        body["tie_word_embeddings"] = False
    return dict(sorted(body.items()))


def hf_t5_state(cfg, draw: Draw, decoder: bool = False) -> tuple:
    """transformers T5EncoderModel keys, or T5ForConditionalGeneration's
    with decoder=True (the decoder stack and lm_head, which holds the shared
    embedding when the embeddings are tied), and the config.json body."""
    out = {}
    inner = cfg.d_kv * cfg.num_heads
    d = cfg.d_model

    def w(name, *shape, like=None):
        out[name] = draw.weight(like or name, *shape)

    w("shared.weight", cfg.vocab_size, d)
    w("encoder.embed_tokens.weight", cfg.vocab_size, d, like="shared.weight")

    def attn(prefix):
        for n, shape in (("q", (inner, d)), ("k", (inner, d)), ("v", (inner, d)), ("o", (d, inner))):
            w(f"{prefix}.{n}.weight", *shape)

    def ffn(prefix):
        if cfg.feed_forward_proj.startswith("gated"):
            w(f"{prefix}.wi_0.weight", cfg.d_ff, d)
            w(f"{prefix}.wi_1.weight", cfg.d_ff, d)
        else:
            w(f"{prefix}.wi.weight", cfg.d_ff, d)
        w(f"{prefix}.wo.weight", d, cfg.d_ff)

    def ln(name):
        out[name] = draw.scale(name, d)

    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}"
        attn(f"{b}.layer.0.SelfAttention")
        if i == 0:
            w(f"{b}.layer.0.SelfAttention.relative_attention_bias.weight",
              cfg.relative_attention_num_buckets, cfg.num_heads)
        ln(f"{b}.layer.0.layer_norm.weight")
        ffn(f"{b}.layer.1.DenseReluDense")
        ln(f"{b}.layer.1.layer_norm.weight")
    ln("encoder.final_layer_norm.weight")
    if decoder:
        w("decoder.embed_tokens.weight", cfg.vocab_size, d, like="shared.weight")
        for i in range(cfg.num_decoder_layers or cfg.num_layers):
            b = f"decoder.block.{i}"
            attn(f"{b}.layer.0.SelfAttention")
            if i == 0:
                w(f"{b}.layer.0.SelfAttention.relative_attention_bias.weight",
                  cfg.relative_attention_num_buckets, cfg.num_heads)
            ln(f"{b}.layer.0.layer_norm.weight")
            attn(f"{b}.layer.1.EncDecAttention")
            ln(f"{b}.layer.1.layer_norm.weight")
            ffn(f"{b}.layer.2.DenseReluDense")
            ln(f"{b}.layer.2.layer_norm.weight")
        ln("decoder.final_layer_norm.weight")
        w("lm_head.weight", cfg.vocab_size, d, like="shared.weight" if cfg.tie_word_embeddings else None)
    return out, t5_config_body(cfg, decoder)


# ------------------------------------------------------------ EnCodec


def encodec_config_body(cfg) -> dict:
    """The config.json body transformers writes for an EncodecModel."""
    body = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(cfg).items()}
    body["model_type"] = "encodec"
    return dict(sorted(body.items()))


def hf_encodec_state(cfg, draw: Draw) -> tuple:
    """transformers EncodecModel keys (weight-normed convs under
    parametrizations.weight.original0/1, nn.LSTM names, ELUs counted in the
    layer indices, the codebooks with their EMA buffers) and the config.json
    body."""
    from ..models.musicgen.encodec import decoder_spec, encoder_spec

    if cfg.norm_type != "weight_norm":
        raise ValueError(f"norm_type {cfg.norm_type!r}: only weight_norm checkpoints are written")
    out = {}

    def conv(prefix, cin, cout, k, transposed=False):
        norm_dim = cin if transposed else cout
        out[f"{prefix}.conv.bias"] = draw.weight(f"{prefix}.conv.bias", cout)
        g = f"{prefix}.conv.parametrizations.weight.original0"
        v = f"{prefix}.conv.parametrizations.weight.original1"
        out[g] = draw.uniform(g, (norm_dim, 1, 1), 0.5, 1.5)
        out[v] = draw.normal(v, (cin, cout, k) if transposed else (cout, cin, k), std=1.0)

    def lstm(prefix, dim):
        bound = 1.0 / math.sqrt(dim)
        for j in range(cfg.num_lstm_layers):
            for name, shape in ((f"weight_ih_l{j}", (4 * dim, dim)), (f"weight_hh_l{j}", (4 * dim, dim)),
                                (f"bias_ih_l{j}", (4 * dim,)), (f"bias_hh_l{j}", (4 * dim,))):
                out[f"{prefix}.lstm.{name}"] = draw.uniform(f"{prefix}.lstm.{name}", shape, -bound, bound)

    for side, spec in (("encoder", encoder_spec(cfg)), ("decoder", decoder_spec(cfg))):
        for i, entry in enumerate(spec):
            prefix = f"{side}.layers.{i}"
            kind = entry[0]
            if kind == "conv":
                conv(prefix, entry[1], entry[2], entry[3])
            elif kind == "convtr":
                conv(prefix, entry[1], entry[2], entry[3], transposed=True)
            elif kind == "resnet":
                dim, hidden = entry[1], entry[1] // cfg.compress
                conv(f"{prefix}.block.1", dim, hidden, cfg.residual_kernel_size)
                conv(f"{prefix}.block.3", hidden, dim, 1)
                if cfg.use_conv_shortcut:
                    conv(f"{prefix}.shortcut", dim, dim, 1)
            elif kind == "lstm":
                lstm(prefix, entry[1])
    for q in range(cfg.num_quantizers):
        p = f"quantizer.layers.{q}.codebook"
        out[f"{p}.inited"] = Lazy((1,), draw.dtype, lambda: torch.ones(1, dtype=draw.dtype))
        out[f"{p}.cluster_size"] = draw.uniform(f"{p}.cluster_size", (cfg.codebook_size,), 0.5, 1.5)
        out[f"{p}.embed"] = draw.normal(f"{p}.embed", (cfg.codebook_size, cfg.codebook_dim), std=1.0)
        out[f"{p}.embed_avg"] = draw.normal(f"{p}.embed_avg", (cfg.codebook_size, cfg.codebook_dim), std=1.0)
    return out, encodec_config_body(cfg)


def audiocraft_musicgen_state(cfg, draw: Draw) -> dict:
    """MusicGen's decoder in audiocraft's state_dict.bin["best_state"] names:
    fused in_proj q|k|v, emb/linears lists, the text projection of the
    condition provider."""
    h = cfg.hidden_size
    out = {}

    def w(name, *shape):
        out[name] = draw.weight(name, *shape)

    for i in range(cfg.num_hidden_layers):
        p = f"transformer.layers.{i}"
        for attn in ("self_attn", "cross_attention"):
            w(f"{p}.{attn}.in_proj_weight", 3 * h, h)
            w(f"{p}.{attn}.out_proj.weight", h, h)
        for ln in ("norm1", "norm_cross", "norm2"):
            out[f"{p}.{ln}.weight"] = draw.scale(f"{p}.{ln}.weight", h)
            w(f"{p}.{ln}.bias", h)
        w(f"{p}.linear1.weight", cfg.ffn_dim, h)
        w(f"{p}.linear2.weight", h, cfg.ffn_dim)
    for k in range(cfg.num_codebooks):
        w(f"emb.{k}.weight", cfg.codebook_size + 1, h)
        w(f"linears.{k}.weight", cfg.codebook_size, h)
    out["out_norm.weight"] = draw.scale("out_norm.weight", h)
    w("out_norm.bias", h)
    w("condition_provider.conditioners.description.output_proj.weight", h, cfg.text_d_model)
    w("condition_provider.conditioners.description.output_proj.bias", h)
    return out


# ------------------------------------------------- SD UNet / VAE (diffusers)


def hf_sd_unet_state(cfg, draw: Draw) -> dict:
    """diffusers UNet2DConditionModel key layout: OIHW convs, 1×1-conv
    transformer projections, packed GEGLU ff.net.0.proj, fused time/add
    embeddings; up blocks deepest first."""
    st = _ConvState(draw)
    temb = cfg.temb_dim

    def resnet(prefix, cin, cout):
        st.gn(f"{prefix}.norm1", cin)
        st.conv(f"{prefix}.conv1", cin, cout)
        st.lin(f"{prefix}.time_emb_proj", temb, cout)
        st.gn(f"{prefix}.norm2", cout)
        st.conv(f"{prefix}.conv2", cout, cout)
        if cin != cout:
            st.conv(f"{prefix}.conv_shortcut", cin, cout, 1)

    def transformer2d(prefix, c, level):
        d, xd = c, cfg.cross_attention_dim[level]
        st.gn(f"{prefix}.norm", c)
        st.conv(f"{prefix}.proj_in", c, d, 1)
        for k in range(cfg.transformer_layers_per_block[level]):
            b = f"{prefix}.transformer_blocks.{k}"
            st.gn(f"{b}.norm1", d)
            for name, mem in (("attn1", d), ("attn2", xd)):
                st.lin(f"{b}.{name}.to_q", d, d, bias=False)
                st.lin(f"{b}.{name}.to_k", mem, d, bias=False)
                st.lin(f"{b}.{name}.to_v", mem, d, bias=False)
                st.lin(f"{b}.{name}.to_out.0", d, d)
            st.gn(f"{b}.norm2", d)
            st.gn(f"{b}.norm3", d)
            st.lin(f"{b}.ff.net.0.proj", d, 8 * d)  # packed value|gate GEGLU
            st.lin(f"{b}.ff.net.2", 4 * d, d)
        st.conv(f"{prefix}.proj_out", d, c, 1)

    n = len(cfg.block_out_channels)
    c0 = cfg.block_out_channels[0]
    st.conv("conv_in", cfg.in_channels, c0, cfg.conv_in_kernel)
    st.lin("time_embedding.linear_1", c0, temb)
    st.lin("time_embedding.linear_2", temb, temb)
    if cfg.addition_embed_type == "text_time":
        st.lin("add_embedding.linear_1", cfg.projection_class_embeddings_input_dim, temb)
        st.lin("add_embedding.linear_2", temb, temb)

    chans = [c0] + list(cfg.block_out_channels)
    for i, (ic, oc) in enumerate(zip(chans, chans[1:])):
        p = f"down_blocks.{i}"
        cross = "CrossAttn" in cfg.down_block_types[i]
        cur = ic
        for j in range(cfg.layers_per_block[i]):
            resnet(f"{p}.resnets.{j}", cur, oc)
            cur = oc
            if cross:
                transformer2d(f"{p}.attentions.{j}", oc, i)
        if i < n - 1:
            st.conv(f"{p}.downsamplers.0.conv", oc, oc)

    cl = cfg.block_out_channels[-1]
    resnet("mid_block.resnets.0", cl, cl)
    transformer2d("mid_block.attentions.0", cl, n - 1)
    resnet("mid_block.resnets.1", cl, cl)

    chans = [c0] + list(cfg.block_out_channels) + [cl]
    triples = list(enumerate(zip(chans, chans[1:], chans[2:])))
    for idx, (i, (ic, oc, po)) in enumerate(reversed(triples)):
        p = f"up_blocks.{idx}"
        cross = "CrossAttn" in cfg.up_block_types[i]
        n_layers = cfg.layers_per_block[i] + 1
        ins = [po] + [oc] * (n_layers - 1)
        skips = [oc] * (n_layers - 1) + [ic]
        for j, (a, b) in enumerate(zip(ins, skips)):
            resnet(f"{p}.resnets.{j}", a + b, oc)
            if cross:
                transformer2d(f"{p}.attentions.{j}", oc, i)
        if i > 0:
            st.conv(f"{p}.upsamplers.0.conv", oc, oc)

    st.gn("conv_norm_out", c0)
    st.conv("conv_out", c0, cfg.out_channels, cfg.conv_out_kernel)
    return st.out


def hf_sd_vae_state(cfg, draw: Draw) -> dict:
    """diffusers AutoencoderKL key layout."""
    st = _ConvState(draw)

    def resnet(prefix, cin, cout):
        st.gn(f"{prefix}.norm1", cin)
        st.conv(f"{prefix}.conv1", cin, cout)
        st.gn(f"{prefix}.norm2", cout)
        st.conv(f"{prefix}.conv2", cout, cout)
        if cin != cout:
            st.conv(f"{prefix}.conv_shortcut", cin, cout, 1)

    def attn(prefix, c):
        st.gn(f"{prefix}.group_norm", c)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            st.lin(f"{prefix}.{name}", c, c)

    boc = list(cfg.block_out_channels)
    n = len(boc)
    st.conv("encoder.conv_in", cfg.in_channels, boc[0])
    chans = [boc[0]] + boc
    for i, (ic, oc) in enumerate(zip(chans, chans[1:])):
        p = f"encoder.down_blocks.{i}"
        cur = ic
        for j in range(cfg.layers_per_block):
            resnet(f"{p}.resnets.{j}", cur, oc)
            cur = oc
        if i < n - 1:
            st.conv(f"{p}.downsamplers.0.conv", oc, oc)
    resnet("encoder.mid_block.resnets.0", boc[-1], boc[-1])
    attn("encoder.mid_block.attentions.0", boc[-1])
    resnet("encoder.mid_block.resnets.1", boc[-1], boc[-1])
    st.gn("encoder.conv_norm_out", boc[-1])
    st.conv("encoder.conv_out", boc[-1], cfg.latent_channels_out)

    st.conv("decoder.conv_in", cfg.latent_channels_in, boc[-1])
    resnet("decoder.mid_block.resnets.0", boc[-1], boc[-1])
    attn("decoder.mid_block.attentions.0", boc[-1])
    resnet("decoder.mid_block.resnets.1", boc[-1], boc[-1])
    rev = list(reversed(boc))
    chans = [rev[0]] + rev
    for i, (ic, oc) in enumerate(zip(chans, chans[1:])):
        p = f"decoder.up_blocks.{i}"
        cur = ic
        for j in range(cfg.layers_per_block + 1):
            resnet(f"{p}.resnets.{j}", cur, oc)
            cur = oc
        if i < n - 1:
            st.conv(f"{p}.upsamplers.0.conv", oc, oc)
    st.gn("decoder.conv_norm_out", boc[0])
    st.conv("decoder.conv_out", boc[0], cfg.out_channels)
    st.conv("quant_conv", cfg.latent_channels_out, cfg.latent_channels_out, 1)
    st.conv("post_quant_conv", cfg.latent_channels_in, cfg.latent_channels_in, 1)
    return st.out


# ------------------------------------------------------------ tokenizer files

SPM_VOCAB = [
    ("▁", -2.0), ("▁the", -1.2), ("▁a", -1.1),
    ("▁photo", -1.8), ("▁of", -1.2), ("▁cat", -1.5),
    ("▁on", -1.3), ("▁mat", -1.7),
    ("t", -4.0), ("h", -4.1), ("e", -3.9), ("c", -4.2), ("a", -3.8),
    ("s", -4.0), ("o", -3.9), ("n", -4.0), ("m", -4.3), ("p", -4.2),
    ("f", -4.2), ("i", -3.9), ("u", -4.1), ("b", -4.4), ("l", -4.0),
    ("r", -4.0), ("d", -4.1), ("g", -4.3), ("w", -4.4), ("y", -4.2),
    ("k", -4.5), ("v", -4.5), ("x", -4.8), ("j", -4.8), ("q", -4.9),
    ("z", -4.9), ("▁t", -4.5), ("▁c", -4.6), ("▁s", -4.5),
    ("▁b", -4.7), ("▁d", -4.7), ("▁f", -4.6),
    ("▁m", -4.7), ("▁p", -4.7), ("▁w", -4.8),
    ("▁l", -4.8), ("▁g", -4.8), ("▁h", -4.8),
    ("▁n", -4.8), ("▁r", -4.8), ("▁o", -4.8),
    ("▁e", -4.8), ("▁i", -4.8), ("▁u", -4.9),
    ("▁v", -4.9), ("▁k", -4.9), ("▁y", -4.9),
    ("▁j", -5.0), ("▁x", -5.0), ("▁q", -5.0),
    ("▁z", -5.0), ("▁1", -4.6), ("▁2", -4.6),
    ("1", -4.9), ("2", -4.9), ("3", -4.9), ("4", -4.9),
]

CLIP_CORPUS = [
    "a photo of a cat sitting on the mat",
    "the quick brown fox jumps over the lazy dog",
    "an oil painting of the sea and the sky",
    "it's a detailed photograph of the mountains",
] * 4


def write_clip_tokenizer(directory) -> int:
    """vocab.json and merges.txt learned from the corpus; the vocabulary's
    size."""
    from ..tokenizers.assets import write_clip_assets

    return len(write_clip_assets(directory, CLIP_CORPUS, num_merges=128)[0])


def write_spiece(path, vocab_size: Optional[int] = None) -> None:
    """A T5-style spiece.model; with `vocab_size`, filled out with pieces
    "▁x0", "▁x1", … to that many, so that every id a model of that
    vocabulary emits decodes (t5_generate's greedy output)."""
    from ..tokenizers.assets import build_unigram_pieces, write_spiece_model

    vocab = list(SPM_VOCAB)
    if vocab_size:
        vocab += [(f"▁x{i}", -12.0) for i in range(vocab_size - len(build_unigram_pieces(vocab, True)))]
    write_spiece_model(path, vocab, byte_fallback=True)


# ------------------------------------------------------------ repositories


def _json(path, body) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(body))


def repo_dir(root, repo_id: str, hub: bool) -> Path:
    """Where `repo_id`'s files go: `root` itself, or with `hub` its snapshot
    in the hub cache at `root` (refs/main naming a commit derived from the
    id)."""
    root = Path(root)
    if not hub:
        root.mkdir(parents=True, exist_ok=True)
        return root
    repo = root / f"models--{repo_id.replace('/', '--')}"
    commit = hashlib.sha1(repo_id.encode()).hexdigest()
    (repo / "refs").mkdir(parents=True, exist_ok=True)
    (repo / "refs" / "main").write_text(commit)
    snap = repo / "snapshots" / commit
    snap.mkdir(parents=True, exist_ok=True)
    return snap


def tiny_flux_configs(clip_vocab_size: int = 642, quantizable: bool = False):
    """The JAX package's tiny Flux cache configs (flow, AE, CLIP, T5): CLIP's
    pooled width feeds vec_in, T5's d_model context_in, the AE's 4 ·
    z_channels the flow's in_channels; `quantizable` lifts the flow to
    hidden 512 so the int8 predicate (in % 512 == 0) fires."""
    from ..models.clip.text import tiny_clip_config
    from ..models.flux.autoencoder import tiny_ae_config
    from ..models.flux.model import tiny_flux_config
    from ..models.t5.t5 import tiny_t5_config

    flow = (tiny_flux_config(hidden_size=512, num_heads=4, axes_dim=(32, 48, 48)) if quantizable
            else tiny_flux_config())
    return (flow, tiny_ae_config(), tiny_clip_config(model_dims=24, num_heads=4, vocab_size=clip_vocab_size),
            tiny_t5_config(d_model=32, d_kv=8, num_heads=4, d_ff=48, vocab_size=512))


def make_flux_cache(root, configs=None, quantizable: bool = False, dtype=torch.float32, device=None,
                    hub: bool = False):
    """A Flux-schnell repository: the flow and AE files, text_encoder/
    (CLIP-L), text_encoder_2/ (T5, two shards with their index), tokenizer/
    and tokenizer_2/spiece.model, drawn on `device` (the current CUDA device
    when None). `configs` (flow, ae, clip, t5) default to the tiny ones,
    with CLIP's vocabulary that of the tokenizer written; pass
    registry.flux_configs("flux-schnell") for the published widths. Returns
    the configs."""
    spec = registry.FLUX_MODELS["flux-schnell"]
    base = repo_dir(root, spec.repo_id, hub)
    clip_vocab = write_clip_tokenizer(base / "tokenizer")
    write_spiece(base / "tokenizer_2" / "spiece.model")
    flow_cfg, ae_cfg, clip_cfg, t5_cfg = configs or tiny_flux_configs(clip_vocab, quantizable)
    draw = Draw(0, dtype, device)
    save_safetensors(base / spec.repo_flow, bfl_flux_state(flow_cfg, draw))
    save_safetensors(base / spec.repo_ae, bfl_flux_ae_state(ae_cfg, draw))
    clip_sd, _ = hf_clip_state(clip_cfg, draw)
    save_safetensors(base / "text_encoder" / "model.safetensors", clip_sd)
    t5_sd, _ = hf_t5_state(t5_cfg, draw)
    save_sharded_safetensors(base / "text_encoder_2", t5_sd, n_shards=2)
    return flow_cfg, ae_cfg, clip_cfg, t5_cfg


def tiny_sd_configs(xl: bool, clip_vocab_size: int):
    """The JAX package's tiny SD (or SDXL) cache configs: (UNet, VAE,
    (CLIP, ...))."""
    from ..models.clip.text import CLIPTextConfig
    from ..models.sd.config import tiny_sd_ae_config, tiny_unet_config

    unet = tiny_unet_config(
        addition_embed_type="text_time" if xl else None,
        addition_time_embed_dim=8 if xl else None,
        projection_class_embeddings_input_dim=(24 + 6 * 8) if xl else None,
        cross_attention_dim=(40, 40) if xl else (16, 16),
    )
    clips = [CLIPTextConfig(num_layers=2, model_dims=16, num_heads=4, max_length=16,
                            vocab_size=clip_vocab_size, hidden_act="quick_gelu")]
    if xl:
        clips.append(CLIPTextConfig(num_layers=2, model_dims=24, num_heads=4, max_length=16,
                                    vocab_size=clip_vocab_size, hidden_act="quick_gelu", projection_dim=24))
    return unet, tiny_sd_ae_config(), tuple(clips)


def unet_config_body(cfg) -> dict:
    """The unet/config.json fields the loaders read (diffusers' names:
    `attention_head_dim` holds the heads a level, up blocks deepest first)."""
    return {
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block[0],
        "transformer_layers_per_block": list(cfg.transformer_layers_per_block),
        "attention_head_dim": list(cfg.num_attention_heads),
        "cross_attention_dim": list(cfg.cross_attention_dim),
        "norm_num_groups": cfg.norm_num_groups,
        "down_block_types": list(cfg.down_block_types),
        "up_block_types": list(cfg.up_block_types[::-1]),
        "addition_embed_type": cfg.addition_embed_type,
        "addition_time_embed_dim": cfg.addition_time_embed_dim,
        "projection_class_embeddings_input_dim": cfg.projection_class_embeddings_input_dim,
    }


def make_sd_cache(root, xl: bool = False, configs=None, dtype=torch.float32, device=None, hub: bool = False):
    """A diffusers repository (SD 2.1-base, or SDXL-Turbo with `xl`): unet/,
    vae/, text_encoder/ (and text_encoder_2/), tokenizer/ (and tokenizer_2/)
    and scheduler/, configs in their config.json files, drawn on `device`
    (the current CUDA device when None). `configs` (UNet,
    VAE, (CLIP, ...)) default to the tiny ones; registry.sd_configs(name)
    gives the published. Returns (UNet, VAE) configs."""
    repo_id = registry.SD_MODELS["sdxl-turbo" if xl else "stable-diffusion-2-1-base"]["repo_id"]
    base = repo_dir(root, repo_id, hub)
    clip_vocab = write_clip_tokenizer(base / "tokenizer")
    if xl:
        write_clip_tokenizer(base / "tokenizer_2")
    unet_cfg, ae_cfg, clip_cfgs = configs or tiny_sd_configs(xl, clip_vocab)
    draw = Draw(0, dtype, device)
    _json(base / "unet" / "config.json", unet_config_body(unet_cfg))
    save_safetensors(base / "unet" / "diffusion_pytorch_model.safetensors", hf_sd_unet_state(unet_cfg, draw))
    _json(base / "vae" / "config.json", {
        "in_channels": ae_cfg.in_channels, "out_channels": ae_cfg.out_channels,
        "latent_channels": ae_cfg.latent_channels_in, "block_out_channels": list(ae_cfg.block_out_channels),
        "layers_per_block": ae_cfg.layers_per_block, "norm_num_groups": ae_cfg.norm_num_groups,
        "scaling_factor": ae_cfg.scaling_factor,
    })
    save_safetensors(base / "vae" / "diffusion_pytorch_model.safetensors", hf_sd_vae_state(ae_cfg, draw))
    for sub, cfg in zip(("text_encoder", "text_encoder_2"), clip_cfgs):
        sd, body = hf_clip_state(cfg, draw)
        _json(base / sub / "config.json", body)
        save_safetensors(base / sub / "model.safetensors", sd)
    _json(base / "scheduler" / "scheduler_config.json", {
        "beta_schedule": "scaled_linear", "beta_start": 0.00085, "beta_end": 0.012,
        "num_train_timesteps": 1000,
    })
    return unet_cfg, ae_cfg


def make_t5_cache(root, cfg, device=None, hub: bool = False) -> Path:
    """A full T5 repository as t5-base ships, in f32: config.json,
    model.safetensors (encoder, decoder, lm_head) and spiece.model, drawn on
    `device` (the current CUDA device when None); with `hub`, as t5-base.
    Returns its directory."""
    base = repo_dir(root, "t5-base", hub)
    sd, body = hf_t5_state(cfg, Draw(0, torch.float32, device), decoder=True)
    _json(base / "config.json", body)
    save_safetensors(base / "model.safetensors", sd)
    write_spiece(base / "spiece.model", cfg.vocab_size)
    return base


def tiny_musicgen_configs():
    """The JAX package's tiny MusicGen cache configs (decoder, T5, EnCodec):
    the codec's bandwidth sized so it builds num_codebooks quantizers."""
    from ..models.musicgen.encodec import tiny_encodec_config
    from ..models.musicgen.model import tiny_musicgen_config
    from ..models.t5.t5 import tiny_t5_config

    mg_cfg = tiny_musicgen_config()
    enc_cfg = tiny_encodec_config(codebook_size=mg_cfg.codebook_size)
    bw = mg_cfg.num_codebooks * enc_cfg.frame_rate * enc_cfg.codebook_nbits / 1000
    return (mg_cfg, tiny_t5_config(d_model=mg_cfg.text_d_model, vocab_size=512),
            tiny_encodec_config(codebook_size=mg_cfg.codebook_size, target_bandwidths=(bw,)))


def make_musicgen_cache(root, configs=None, dtype=torch.float32, device=None, hub: bool = False):
    """A facebook/musicgen-* repository: config.json and the torch
    state_dict.bin, with the T5 text encoder and the EnCodec codec. As a
    local directory (the JAX layout) T5's encoder and the codec go in its
    text_encoder/ and encodec/; with `hub` they are the repositories the
    config names, t5-base as a full T5 (make_t5_cache) and
    mlx-community/encodec-32khz-float32. T5 and EnCodec are f32, the
    decoder `dtype`, all drawn on `device` (the current CUDA device when
    None). `configs` (decoder, T5, EnCodec) default to the tiny ones; registry.musicgen_configs() gives
    the published. Returns the configs."""
    mg_cfg, t5_cfg, enc_cfg = configs or tiny_musicgen_configs()
    t5_repo = "t5-base" if hub else "synthetic/t5-tiny"
    enc_repo = "facebook/encodec_32khz" if hub else "synthetic/encodec_tiny"
    base = repo_dir(root, registry.MUSICGEN_REPO, hub)
    _json(base / "config.json", {
        "decoder": {
            "num_codebooks": mg_cfg.num_codebooks, "bos_token_id": mg_cfg.bos_token_id,
            "hidden_size": mg_cfg.hidden_size, "num_attention_heads": mg_cfg.num_attention_heads,
            "num_hidden_layers": mg_cfg.num_hidden_layers, "ffn_dim": mg_cfg.ffn_dim,
        },
        "audio_encoder": {"codebook_size": mg_cfg.codebook_size, "sampling_rate": mg_cfg.sampling_rate,
                          "_name_or_path": enc_repo},
        "text_encoder": {"d_model": mg_cfg.text_d_model, "_name_or_path": t5_repo},
    })
    best = {k: v.make().cpu() for k, v in audiocraft_musicgen_state(mg_cfg, Draw(0, dtype, device)).items()}
    torch.save({"best_state": best}, base / "state_dict.bin")
    del best
    f32 = Draw(0, torch.float32, device)
    if hub:
        make_t5_cache(root, t5_cfg, f32.device, hub=True)
        enc_dir = repo_dir(root, registry.ENCODEC_REPO, hub=True)
    else:
        t5_sd, t5_body = hf_t5_state(t5_cfg, f32)
        _json(base / "text_encoder" / "config.json", t5_body)
        save_safetensors(base / "text_encoder" / "model.safetensors", t5_sd)
        write_spiece(base / "text_encoder" / "spiece.model")
        enc_dir = base / "encodec"
    enc_sd, enc_body = hf_encodec_state(enc_cfg, f32)
    _json(enc_dir / "config.json", enc_body)
    save_safetensors(enc_dir / "model.safetensors", enc_sd)
    return mg_cfg, t5_cfg, enc_cfg


def cache_bytes(root) -> int:
    """Bytes of every file under `root`."""
    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file())

