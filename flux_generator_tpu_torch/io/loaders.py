"""Checkpoint loaders: a local checkpoint directory, or a repo in the local
Hugging Face hub cache → assembled pipelines (the port's counterpart of
flux_generator_tpu/io/loaders.py).

Each loader reads safetensors files (sharded ones through their
*.index.json), maps the keys (io/sanitize.py), assembles the tree
(io/params.unflatten), holds it against a template of the expected shapes,
built by the port's own init functions on torch's "meta" device (no memory
is allocated), then casts it to the pipeline's dtype, or quantizes it, one
tensor at a time on the host before it moves to the device. Each model
moves before the next file is read, so the host holds one model's mapped
file and stacked layers at a time (the mapping lives as long as any
tensor viewing it). A wrong or
missing tensor fails at load with its path. The FLUX_DEV / FLUX_SCHNELL / AE
environment variables name checkpoint files in place of the registry's.

Nothing is downloaded. Without `local_dir`, a repo id is resolved in the
local hub cache as huggingface_hub resolves it offline: $HF_HUB_CACHE, else
$HF_HOME/hub, else ~/.cache/huggingface/hub, then
models--{org}--{name}/snapshots/<the commit refs/main names>/; a missing file
raises FileNotFoundError with its path.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

from ..runtime.device import as_device
from . import registry, sanitize
from .params import tree_map, unflatten
from .safetensors import load_safetensors, load_sharded_safetensors

META = torch.device("meta")


# ------------------------------------------------------------ local hub cache


def hub_cache_dir() -> Path:
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    return Path.home() / ".cache" / "huggingface" / "hub"


def hf_snapshot(repo_id: str, revision: str = "main") -> Path:
    """The snapshot directory of `repo_id` at `revision` (a ref or a commit)
    in the local hub cache."""
    repo = hub_cache_dir() / f"models--{repo_id.replace('/', '--')}"
    ref = repo / "refs" / revision
    commit = ref.read_text().strip() if ref.is_file() else revision
    snap = repo / "snapshots" / commit
    if not snap.is_dir():
        raise FileNotFoundError(f"{repo_id} is not in the local Hugging Face hub cache: no {snap} "
                                f"(pass local_dir=, or set HF_HUB_CACHE / HF_HOME)")
    return snap


def hf_download(repo_id: str, filename: str) -> Path:
    """A file of `repo_id` in the local hub cache."""
    path = hf_snapshot(repo_id) / filename
    if not path.exists():
        raise FileNotFoundError(f"{repo_id}: no {path} in the local Hugging Face hub cache")
    return path


# ------------------------------------------------------------ structure check


def conform_params(got_tree, template, name: str):
    """Hold an assembled tree against a template of the model's shapes (a
    meta-device tree): drop branches the model has not (schnell checkpoints
    ship an unused guidance_in), fail on missing ones and on wrong shapes,
    naming the path."""

    def walk(got, want, path):
        if isinstance(want, dict):
            if not isinstance(got, dict):
                raise ValueError(f"{name}: expected dict at {path}, got {type(got)}")
            out = {}
            for k, w in want.items():
                if k not in got:
                    raise ValueError(f"{name}: missing param {path}/{k}")
                out[k] = walk(got[k], w, f"{path}/{k}")
            return out
        if isinstance(want, list):
            if len(got) != len(want):
                raise ValueError(f"{name}: list length mismatch at {path}: {len(got)} vs {len(want)}")
            return [walk(g, w, f"{path}/{i}") for i, (g, w) in enumerate(zip(got, want))]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape mismatch at {path}: checkpoint {tuple(got.shape)} vs "
                             f"model {tuple(want.shape)}")
        return got

    return walk(got_tree, template, name)


def cast_tree(tree, dtype, device=None):
    """Floating leaves to `dtype`, every leaf to `device`, one at a time."""

    def one(x):
        x = x.to(dtype) if x.is_floating_point() else x
        return x.to(device) if device is not None else x

    return tree_map(one, tree)


def _quantized(tree, dtype, device, **kwargs):
    from ..ops.quant import quantize_tree_to_device

    return quantize_tree_to_device(tree, dtype=dtype, device=device, **kwargs)


# ------------------------------------------------------------ Flux


def load_flux_pipeline(name: str = "flux-schnell", dtype=torch.bfloat16, local_dir: Optional[str] = None,
                       quantize=False, configs=None, device=None, w8a8: Optional[str] = None,
                       attn_int8: str = ""):
    """FluxPipeline from BFL's flow and autoencoder files and the repo's
    text_encoder/ (CLIP-L), text_encoder_2/ (T5-XXL, sharded) and tokenizer
    directories. `quantize`: False (bf16), True or "int8" (flow and T5 int8
    per channel) or "int4" (flow int4 in groups of 128, packed; T5 int8).
    `configs` (flow, ae, clip, t5) replaces the registry's, for checkpoints
    at other widths."""
    from ..models.clip.text import init_clip_text
    from ..models.flux.autoencoder import init_autoencoder
    from ..models.flux.model import init_flux
    from ..models.t5.t5 import init_t5_encoder
    from ..pipelines.flux import FluxPipeline
    from ..tokenizers.clip_bpe import CLIPTokenizer
    from ..tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer

    device = as_device(device)
    spec = registry.FLUX_MODELS[name]
    flow_cfg, ae_cfg, clip_cfg, t5_cfg = configs or registry.flux_configs(name)
    root = Path(local_dir) if local_dir else None

    def repo_file(rel):
        return root / rel if root else hf_download(spec.repo_id, rel)

    params = {}
    flow_file = registry.flux_ckpt_override(name) or repo_file(spec.repo_flow)
    flow = unflatten(sanitize.sanitize_flux(load_safetensors(flow_file)), sanitize.FLUX_STACKS)
    flow = conform_params(flow, init_flux(None, flow_cfg, device=META), "flux-flow")
    # weight-only on the big matmuls, quantized before each tensor moves
    if quantize == "int4":
        params["flow"] = _quantized(flow, dtype, device, bits=4, group_size=128, pack=True)
    else:
        params["flow"] = _quantized(flow, dtype, device) if quantize else cast_tree(flow, dtype, device)
    del flow

    ae_file = registry.ae_ckpt_override() or repo_file(spec.repo_ae)
    ae = unflatten(sanitize.sanitize_flux_ae(load_safetensors(ae_file)), ())
    params["ae"] = cast_tree(conform_params(ae, init_autoencoder(None, ae_cfg, device=META), "flux-ae"), dtype,
                             device)
    del ae

    base = root or hf_snapshot(spec.repo_id)
    clip = unflatten(sanitize.sanitize_clip(load_safetensors(base / "text_encoder" / "model.safetensors")),
                     sanitize.CLIP_STACKS)
    params["clip"] = cast_tree(conform_params(clip, init_clip_text(None, clip_cfg, device=META), "clip"), dtype,
                               device)
    del clip
    clip_tok = CLIPTokenizer.from_pretrained_dir(base / "tokenizer")

    t5_root = base / "text_encoder_2"
    if (t5_root / "model.safetensors.index.json").exists():
        raw = load_sharded_safetensors(t5_root, "model.safetensors.index.json")
    else:
        raw = load_safetensors(t5_root / "model.safetensors")
    t5 = unflatten(sanitize.sanitize_t5(raw), sanitize.T5_STACKS)
    del raw
    t5 = conform_params(t5, init_t5_encoder(None, t5_cfg, device=META), "t5")
    params["t5"] = _quantized(t5, dtype, device) if quantize else cast_tree(t5, dtype, device)
    del t5
    t5_tok = SentencePieceUnigramTokenizer.from_file(base / "tokenizer_2" / "spiece.model",
                                                     max_length=spec.t5_max_length)
    return FluxPipeline(name, params, flow_cfg, ae_cfg, clip_cfg, t5_cfg, clip_tokenizer=clip_tok,
                        t5_tokenizer=t5_tok, dtype=dtype, w8a8=w8a8, attn_int8=attn_int8)


# ------------------------------------------------------------ SD


def _sd_files(model: str, local_dir: Optional[str]):
    if local_dir:
        root = Path(local_dir)
        return lambda rel: root / rel
    return lambda rel: hf_download(model, rel)


def _sd_quant_predicate(p) -> bool:
    """SD's int8 policy: dense kernels only ((in, out) or stacked (depth,
    in, out)) with an input dim that is a multiple of 512; 4-D conv kernels
    stay in the working dtype."""
    k = p["kernel"]
    return k.ndim <= 3 and k.shape[-2] % 512 == 0


def _listed(value, n):
    return tuple(value) if isinstance(value, list) else tuple([value] * n)


def sd_unet_config(uc: dict):
    """UNetConfig of a diffusers unet/config.json: `attention_head_dim` is
    the heads a level, scalars repeat over the levels, and up_block_types is
    reversed from its deepest-first order into ours, by level."""
    from ..models.sd.config import UNetConfig

    n = len(uc["block_out_channels"])
    return UNetConfig(
        in_channels=uc["in_channels"],
        out_channels=uc["out_channels"],
        block_out_channels=tuple(uc["block_out_channels"]),
        layers_per_block=tuple([uc["layers_per_block"]] * n),
        transformer_layers_per_block=_listed(uc.get("transformer_layers_per_block", 1), n),
        num_attention_heads=_listed(uc["attention_head_dim"], n),
        cross_attention_dim=_listed(uc["cross_attention_dim"], n),
        norm_num_groups=uc["norm_num_groups"],
        down_block_types=tuple(uc["down_block_types"]),
        up_block_types=tuple(uc["up_block_types"][::-1]),
        addition_embed_type=uc.get("addition_embed_type"),
        addition_time_embed_dim=uc.get("addition_time_embed_dim"),
        projection_class_embeddings_input_dim=uc.get("projection_class_embeddings_input_dim"),
    )


def load_sd_pipeline(model: str = "stabilityai/stable-diffusion-2-1-base", cls=None, dtype=torch.bfloat16,
                     local_dir: Optional[str] = None, quantize: bool = False, device=None,
                     w8a8: Optional[str] = None, attn_int8: str = ""):
    """StableDiffusion or StableDiffusionXL (by "xl" in the name) from a
    diffusers repo layout: configs from its config.json files, weights from
    its safetensors. `quantize` puts the UNet's and the first CLIP's dense
    layers that `_sd_quant_predicate` accepts in int8 per channel."""
    from ..models.clip.text import CLIPTextConfig, init_clip_text
    from ..models.sd.config import AutoencoderConfig, DiffusionConfig
    from ..models.sd.unet import init_unet
    from ..models.sd.vae import init_sd_vae
    from ..pipelines.sd import StableDiffusion, StableDiffusionXL
    from ..tokenizers.clip_bpe import CLIPTokenizer

    device = as_device(device)
    get = _sd_files(model, local_dir)
    is_xl = "xl" in model.lower()
    cls = cls or (StableDiffusionXL if is_xl else StableDiffusion)

    def q(tree):
        if quantize:
            return _quantized(tree, dtype, device, predicate=_sd_quant_predicate)
        return cast_tree(tree, dtype, device)

    with open(get("unet/config.json")) as f:
        unet_cfg = sd_unet_config(json.load(f))
    unet = unflatten(sanitize.sanitize_sd_unet(load_safetensors(get("unet/diffusion_pytorch_model.safetensors"))),
                     ("down_blocks.attentions.blocks", "up_blocks.attentions.blocks", "mid_blocks.blocks"))
    params = {"unet": q(conform_params(unet, init_unet(None, unet_cfg, device=META), "sd-unet"))}
    del unet

    with open(get("vae/config.json")) as f:
        vc = json.load(f)
    ae_cfg = AutoencoderConfig(
        in_channels=vc["in_channels"], out_channels=vc["out_channels"],
        latent_channels_out=2 * vc["latent_channels"], latent_channels_in=vc["latent_channels"],
        block_out_channels=tuple(vc["block_out_channels"]), layers_per_block=vc["layers_per_block"],
        norm_num_groups=vc["norm_num_groups"], scaling_factor=vc.get("scaling_factor", 0.18215))
    vae = unflatten(sanitize.sanitize_sd_vae(load_safetensors(get("vae/diffusion_pytorch_model.safetensors"))), ())
    params["vae"] = cast_tree(conform_params(vae, init_sd_vae(None, ae_cfg, device=META), "sd-vae"), dtype, device)
    del vae

    def load_text_encoder(sub, with_projection=False):
        with open(get(f"{sub}/config.json")) as f:
            tc = json.load(f)
        cfg = CLIPTextConfig(num_layers=tc["num_hidden_layers"], model_dims=tc["hidden_size"],
                             num_heads=tc["num_attention_heads"], max_length=tc["max_position_embeddings"],
                             vocab_size=tc["vocab_size"], hidden_act=tc["hidden_act"],
                             projection_dim=tc.get("projection_dim") if with_projection else None)
        p = unflatten(sanitize.sanitize_clip(load_safetensors(get(f"{sub}/model.safetensors"))),
                      sanitize.CLIP_STACKS)
        return conform_params(p, init_clip_text(None, cfg, device=META), "sd-clip"), cfg

    clip, clip_cfg = load_text_encoder("text_encoder")
    params["clip"] = q(clip)
    del clip
    clip_cfgs = [clip_cfg]
    tokenizers = [CLIPTokenizer.from_files(get("tokenizer/vocab.json"), get("tokenizer/merges.txt"))]
    if is_xl:
        clip2, clip2_cfg = load_text_encoder("text_encoder_2", with_projection=True)
        params["clip_2"] = cast_tree(clip2, dtype, device)
        clip_cfgs.append(clip2_cfg)
        tokenizers.append(CLIPTokenizer.from_files(get("tokenizer_2/vocab.json"), get("tokenizer_2/merges.txt")))

    with open(get("scheduler/scheduler_config.json")) as f:
        sc = json.load(f)
    diff_cfg = DiffusionConfig(beta_schedule=sc["beta_schedule"], beta_start=sc["beta_start"],
                               beta_end=sc["beta_end"], num_train_steps=sc["num_train_timesteps"])
    return cls(model, params, unet_cfg, ae_cfg, clip_cfgs, diff_cfg, tokenizers=tokenizers, dtype=dtype,
               w8a8=w8a8, attn_int8=attn_int8)


# ------------------------------------------------------------ MusicGen


def t5_config(d: dict):
    """T5Config of a transformers config.json (the JAX T5Config.from_dict)."""
    from ..models.t5.t5 import T5Config

    return T5Config(
        vocab_size=d["vocab_size"], num_layers=d["num_layers"], num_heads=d["num_heads"],
        relative_attention_num_buckets=d["relative_attention_num_buckets"], d_kv=d["d_kv"],
        d_model=d["d_model"], feed_forward_proj=d["feed_forward_proj"],
        tie_word_embeddings=d.get("tie_word_embeddings", True), d_ff=d.get("d_ff", 4 * d["d_model"]),
        num_decoder_layers=d.get("num_decoder_layers", d["num_layers"]),
        relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6))


def encodec_config(d: dict):
    """EncodecConfig of a config.json: its known fields, lists as tuples."""
    import dataclasses

    from ..models.musicgen.encodec import EncodecConfig

    fields = {f.name for f in dataclasses.fields(EncodecConfig)}
    return EncodecConfig(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in fields})


def load_musicgen_pipeline(repo: str = "facebook/musicgen-medium", dtype=torch.bfloat16,
                           local_dir: Optional[str] = None, quantize: bool = False, device=None,
                           w8a8: Optional[str] = None):
    """MusicGenPipeline from audiocraft's state_dict.bin ("best_state", read
    by torch.load with weights_only; model.fgt.safetensors in its place when
    present), the T5 text encoder and the EnCodec decoder (f32) the config
    names (text_encoder/ and encodec/ under `local_dir` when present).
    `quantize` puts the decoder's and T5's dense layers in int8 per
    channel."""
    from ..models.musicgen.encodec import EncodecModel, decoder_spec, encoder_spec, init_encodec
    from ..models.musicgen.model import MusicGenConfig, init_musicgen
    from ..models.t5.t5 import init_t5_encoder
    from ..pipelines.musicgen import MusicGenPipeline
    from ..tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer

    device = as_device(device)
    path = Path(local_dir) if local_dir else hf_snapshot(repo)
    with open(path / "config.json") as f:
        config = json.load(f)
    dec = config["decoder"]
    cfg = MusicGenConfig(
        num_codebooks=dec["num_codebooks"], codebook_size=config["audio_encoder"]["codebook_size"],
        bos_token_id=dec["bos_token_id"], hidden_size=dec["hidden_size"],
        num_attention_heads=dec["num_attention_heads"], num_hidden_layers=dec["num_hidden_layers"],
        ffn_dim=dec["ffn_dim"], text_d_model=config["text_encoder"]["d_model"],
        sampling_rate=config["audio_encoder"]["sampling_rate"])
    def place(tree):
        return _quantized(tree, dtype, device) if quantize else cast_tree(tree, dtype, device)

    converted = path / "model.fgt.safetensors"
    if converted.exists():
        flat = load_safetensors(converted)
    else:
        flat = sanitize.sanitize_musicgen(torch.load(path / "state_dict.bin", weights_only=True,
                                                     map_location="cpu")["best_state"])
    params = unflatten(flat, sanitize.MUSICGEN_STACKS)
    del flat
    params = place(conform_params(params, init_musicgen(None, cfg, device=META), "musicgen"))

    t5_repo = config["text_encoder"]["_name_or_path"]
    t5_path = path / "text_encoder" if local_dir and (path / "text_encoder").exists() else hf_snapshot(t5_repo)
    with open(t5_path / "config.json") as f:
        t5_cfg = t5_config(json.load(f))
    t5 = unflatten(sanitize.sanitize_t5(load_safetensors(t5_path / "model.safetensors")), sanitize.T5_STACKS)
    t5.pop("decoder", None)
    t5.pop("lm_head", None)
    t5 = place(conform_params(t5, init_t5_encoder(None, t5_cfg, device=META), "t5"))
    tokenizer = SentencePieceUnigramTokenizer.from_file(t5_path / "spiece.model")

    enc_name = config["audio_encoder"]["_name_or_path"].split("/")[-1].replace("_", "-")
    enc_path = (path / "encodec" if local_dir and (path / "encodec").exists()
                else hf_snapshot(f"mlx-community/{enc_name}-float32"))
    with open(enc_path / "config.json") as f:
        enc_cfg = encodec_config(json.load(f))
    enc_flat = sanitize.sanitize_encodec(load_safetensors(enc_path / "model.safetensors"),
                                         encoder_spec(enc_cfg), decoder_spec(enc_cfg))
    enc_params = conform_params(unflatten(enc_flat, ()), init_encodec(None, enc_cfg, device=META), "encodec")
    codec = EncodecModel(enc_cfg, cast_tree(enc_params, torch.float32, device))
    return MusicGenPipeline(cfg, params, t5_cfg, t5, codec, tokenizer=tokenizer, dtype=dtype, w8a8=w8a8)
