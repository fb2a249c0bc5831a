"""HF / BFL checkpoint key mappers → canonical flat paths and weight
transforms (the port's own copy of flux_generator_tpu/io/sanitize.py, with
the same key rules, on torch tensors).

Each mapper takes a flat {checkpoint name: tensor} dict (torch tensors, or
numpy arrays, which are taken as tensors) and returns a flat
{canonical.dotted.path: tensor} dict ready for io.params.unflatten: kernels
(in, out), convs HWIO / KIO, transformer layers to be stacked. Tensors keep
their dtype, so BF16 checkpoints stay bf16 until the loader casts them.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .params import t_conv1d, t_conv2d, t_convtr1d, t_linear


def _tensor(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(w))


def _sub(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


# ------------------------------------------------------------ Flux flow

_FLUX_RULES = [
    (r"^model\.diffusion_model\.", ""),
    (r"\.img_mod\.lin\.", ".img_mod."),
    (r"\.txt_mod\.lin\.", ".txt_mod."),
    (r"\.modulation\.lin\.", ".modulation."),
    (r"\.norm\.query_norm\.scale$", ".q_norm.scale"),
    (r"\.norm\.key_norm\.scale$", ".k_norm.scale"),
    (r"\.img_mlp\.0\.", ".img_mlp.in."),
    (r"\.img_mlp\.2\.", ".img_mlp.out."),
    (r"\.txt_mlp\.0\.", ".txt_mlp.in."),
    (r"\.txt_mlp\.2\.", ".txt_mlp.out."),
    (r"final_layer\.adaLN_modulation\.1\.", "final_layer.adaLN."),
]


def sanitize_flux(weights: dict) -> dict:
    out = {}
    for k, w in weights.items():
        k = _sub(k, _FLUX_RULES)
        w = _tensor(w)
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 2:
                out[base + ".kernel"] = t_linear(w)
            else:
                out[base + ".scale"] = w
        elif k.endswith(".scale"):
            out[k] = w
        elif k.endswith(".bias"):
            out[k] = w
        else:
            out[k] = w
    return out


FLUX_STACKS = ("double_blocks", "single_blocks")


# ------------------------------------------------------------ Flux VAE

def sanitize_flux_ae(weights: dict) -> dict:
    """BFL ae.safetensors: torchvision-style names already match our tree
    (encoder.down.N.block.M..., mid.attn_1.{q,k,v,proj_out}); 1x1 attn convs
    become linears, 4-D convs go HWIO (flux/autoencoder.py:336-345)."""
    out = {}
    for k, w in weights.items():
        w = _tensor(w)
        k = re.sub(r"\.downsample\.conv\.", ".downsample.", k)
        k = re.sub(r"\.upsample\.conv\.", ".upsample.", k)
        k = re.sub(r"\.nin_shortcut\.", ".nin_shortcut.", k)
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 4:
                if w.shape[2:] == (1, 1):  # attn q/k/v/proj_out 1x1 conv
                    out[base + ".kernel"] = t_linear(w[:, :, 0, 0])
                else:
                    out[base + ".kernel"] = t_conv2d(w)
            elif w.ndim == 2:
                out[base + ".kernel"] = t_linear(w)
            else:  # groupnorm weight
                out[base + ".scale"] = w
        else:
            out[k] = w
    return out


# ------------------------------------------------------------ T5

_T5_RULES = [
    (r"^shared\.weight$", "wte"),
    (r"\.block\.(\d+)\.", r".layers.\1."),
    (r"\.layer\.0\.SelfAttention\.q\.", ".attention.q."),
    (r"\.layer\.0\.SelfAttention\.k\.", ".attention.k."),
    (r"\.layer\.0\.SelfAttention\.v\.", ".attention.v."),
    (r"\.layer\.0\.SelfAttention\.o\.", ".attention.o."),
    (r"\.layer\.1\.EncDecAttention\.q\.", ".cross_attention.q."),
    (r"\.layer\.1\.EncDecAttention\.k\.", ".cross_attention.k."),
    (r"\.layer\.1\.EncDecAttention\.v\.", ".cross_attention.v."),
    (r"\.layer\.1\.EncDecAttention\.o\.", ".cross_attention.o."),
    (r"\.layer\.0\.layer_norm\.", ".ln1."),
    (r"\.layer\.1\.layer_norm\.", ".ln2."),
    (r"\.layer\.2\.layer_norm\.", ".ln3."),
    (r"\.final_layer_norm\.", ".ln."),
]


def sanitize_t5(weights: dict, decoder: bool = False) -> dict:
    """Handles both encoder-only (Flux T5-XXL) and enc-dec (MusicGen T5)."""
    out = {}
    for k, w in weights.items():
        w = _tensor(w)
        if k == "shared.weight":
            out["wte"] = w
            continue
        if k == "lm_head.weight":
            out["lm_head.kernel"] = t_linear(w)
            continue
        if "relative_attention_bias" in k:
            # encoder.block.0.layer.0.SelfAttention.relative_attention_bias
            side = "encoder" if k.startswith("encoder.") else "decoder"
            if side == "decoder" and ".layer.1." in k:
                continue  # unused cross-attn rel bias (musicgen/t5.py ignored_keys)
            out[f"{side}.rel_bias"] = w
            continue
        k = _sub(k, _T5_RULES)
        if k.startswith("decoder."):
            k = k.replace(".attention.", ".self_attention.")
        # DenseReluDense → dense
        k = re.sub(r"\.layer\.\d+\.DenseReluDense\.", ".dense.", k)
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 2 and ".ln" not in base.rsplit(".", 1)[-1]:
                out[base + ".kernel"] = t_linear(w)
            else:
                out[base + ".scale"] = w
        else:
            out[k] = w
    return out


T5_STACKS = ("encoder.layers", "decoder.layers")


# ------------------------------------------------------------ CLIP

_CLIP_RULES = [
    (r"^text_model\.", ""),
    (r"^embeddings\.", ""),
    (r"^encoder\.", ""),
    (r"\.self_attn\.q_proj\.", ".q."),
    (r"\.self_attn\.k_proj\.", ".k."),
    (r"\.self_attn\.v_proj\.", ".v."),
    (r"\.self_attn\.out_proj\.", ".o."),
    (r"\.mlp\.fc1\.", ".fc1."),
    (r"\.mlp\.fc2\.", ".fc2."),
    (r"\.layer_norm1\.", ".ln1."),
    (r"\.layer_norm2\.", ".ln2."),
    (r"^final_layer_norm\.", "final_ln."),
]


def sanitize_clip(weights: dict) -> dict:
    out = {}
    for k, w in weights.items():
        w = _tensor(w)
        if "position_ids" in k:
            continue
        k = _sub(k, _CLIP_RULES)
        if k == "token_embedding.weight":
            out["token_embedding"] = w
            continue
        if k == "position_embedding.weight":
            out["position_embedding"] = w
            continue
        if k == "text_projection.weight":
            out["text_projection.kernel"] = t_linear(w)
            continue
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 2:
                out[base + ".kernel"] = t_linear(w)
            else:
                out[base + ".scale"] = w
        else:
            out[k] = w
    return out


CLIP_STACKS = ("layers",)


# ------------------------------------------------------------ SD UNet / VAE

_SD_SHARED = [
    (r"downsamplers\.0\.conv\.", "downsample."),
    (r"upsamplers\.0\.conv\.", "upsample."),
    (r"mid_block\.resnets\.0\.", "mid_blocks.0."),
    (r"mid_block\.attentions\.0\.", "mid_blocks.1."),
    (r"mid_block\.resnets\.1\.", "mid_blocks.2."),
    (r"\.to_q\.", ".q."),
    (r"\.to_k\.", ".k."),
    (r"\.to_v\.", ".v."),
    (r"\.to_out\.0\.", ".o."),
]

_SD_UNET_RULES = _SD_SHARED + [
    (r"\.ff\.net\.2\.", ".linear3."),
    (r"\.transformer_blocks\.", ".blocks."),
    (r"time_embedding\.linear_1\.", "time_embedding.linear_1."),
    (r"add_embedding\.linear_1\.", "add_embedding.linear_1."),
    (r"\.attn1\.q\.", ".attn1.q."),
    (r"\.norm1\.", ".norm1."),
]


def sanitize_sd_unet(weights: dict) -> dict:
    out = {}
    for k, w in weights.items():
        w = _tensor(w)
        k = _sub(k, _SD_UNET_RULES)
        if ".ff.net.0.proj." in k:
            # GEGLU: HF packs value|gate in one matrix; our linear1=value,
            # linear2=gate (model_io.py:78-82 contract)
            v1, v2 = (c.contiguous() for c in torch.chunk(w, 2, dim=0))
            for name, ww in (("linear1", v1), ("linear2", v2)):
                base = k.replace(".ff.net.0.proj.", f".{name}.")
                if base.endswith(".weight"):
                    out[base[: -len(".weight")] + ".kernel"] = t_linear(ww)
                else:
                    out[base] = ww
            continue
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 4:
                if "proj_in" in k or "proj_out" in k or "conv_shortcut" in k:
                    out[base + ".kernel"] = t_linear(w[:, :, 0, 0])
                else:
                    out[base + ".kernel"] = t_conv2d(w)
            elif w.ndim == 2:
                out[base + ".kernel"] = t_linear(w)
            else:
                out[base + ".scale"] = w
        else:
            out[k] = w
    return out


def sanitize_sd_vae(weights: dict) -> dict:
    out = {}
    for k, w in weights.items():
        w = _tensor(w)
        k = _sub(k, _SD_SHARED)
        k = re.sub(r"\.group_norm\.", ".group_norm.", k)
        k = k.replace("quant_conv.", "quant_proj.").replace(
            "post_quant_proj.", "post_quant_proj."
        )
        if k.startswith("post_quant_conv."):
            k = k.replace("post_quant_conv.", "post_quant_proj.")
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 4:
                if w.shape[2:] == (1, 1) and ("quant_proj" in k or "conv_shortcut" in k):
                    out[base + ".kernel"] = t_linear(w[:, :, 0, 0])
                else:
                    out[base + ".kernel"] = t_conv2d(w)
            elif w.ndim == 2:
                out[base + ".kernel"] = t_linear(w)
            else:
                out[base + ".scale"] = w
        else:
            out[k] = w
    return out


# ------------------------------------------------------------ MusicGen

_MUSICGEN_RULES = [
    (r"^transformer\.", ""),
    (r"cross_attention", "cross_attn"),
    (r"condition_provider\.conditioners\.description\.output_proj\.",
     "text_proj."),
    (r"\.self_attn\.out_proj\.", ".self_attn.o."),
    (r"\.cross_attn\.out_proj\.", ".cross_attn.o."),
]


def sanitize_musicgen(weights: dict) -> dict:
    """MusicGen state_dict.bin["best_state"] → decoder params. The torch
    in_proj_weight (3h, h) maps 1:1 onto our fused qkv kernel (h, 3h) — no
    split needed (our decoder keeps qkv fused for the latency-bound AR loop);
    emb/linears lists → stacked (musicgen/musicgen.py:307-330 contract)."""
    out = {}
    embs, heads = {}, {}
    for k, w in weights.items():
        w = _tensor(w)
        k = _sub(k, _MUSICGEN_RULES)
        if "in_proj_weight" in k:
            out[k.replace("in_proj_weight", "qkv.kernel")] = t_linear(w)
            continue
        m = re.match(r"^emb\.(\d+)\.weight$", k)
        if m:
            embs[int(m.group(1))] = w
            continue
        m = re.match(r"^linears\.(\d+)\.weight$", k)
        if m:
            heads[int(m.group(1))] = t_linear(w)
            continue
        if k.endswith(".weight"):
            base = k[: -len(".weight")]
            if w.ndim == 2:
                out[base + ".kernel"] = t_linear(w)
            else:
                out[base + ".scale"] = w
        else:
            out[k] = w
    if embs:
        out["emb"] = torch.stack([embs[i] for i in range(len(embs))])
    if heads:
        out["linears"] = torch.stack([heads[i] for i in range(len(heads))])
    return out


MUSICGEN_STACKS = ("layers",)


# ------------------------------------------------------------ EnCodec

def fuse_weight_norm(weights: dict) -> dict:
    """Fuse torch weight_norm parametrization (weight_g/weight_v pairs, plus
    the newer parametrizations.weight.original0/1 naming) into plain weights.
    HF EnCodec checkpoints ship weight-normed convs; the mlx-community ones
    are pre-fused."""
    out = dict(weights)
    pairs = []
    for k in list(out):
        if k.endswith(".weight_g"):
            pairs.append((k, k[: -len("_g")] + "_v", k[: -len("_g")]))
        elif k.endswith(".parametrizations.weight.original0"):
            base = k[: -len(".parametrizations.weight.original0")] + ".weight"
            pairs.append((k, k[: -1] + "1", base))
    for gk, vk, wk in pairs:
        g, v = _tensor(out.pop(gk)), _tensor(out.pop(vk))
        # in numpy (in f32 at least), as the JAX package sums it
        work = v.dtype if v.dtype == torch.float64 else torch.float32
        gn, vn = g.to(work).numpy(), v.to(work).numpy()
        norm = np.sqrt(np.sum(vn**2, axis=tuple(range(1, vn.ndim)), keepdims=True))
        out[wk] = torch.from_numpy(gn * vn / np.maximum(norm, 1e-12)).to(v.dtype)
    return out


def sanitize_encodec(weights: dict, enc_spec, dec_spec) -> dict:
    """EnCodec checkpoint names → our spec-indexed lists. Handles both the
    HF transformers layout (weight-normed convs, nn.LSTM weight_ih_l0, ELUs
    counted in layer indices, resnet convs at block.{1,3}) and the
    mlx-community layout (pre-fused convs, lstm.N.Wx) — both share the same
    inclusive layer numbering as our specs."""
    weights = fuse_weight_norm(weights)
    out = {}
    for k, w in weights.items():
        w = _tensor(w)
        k = re.sub(r"^(encoder|decoder)\.layers\.", r"\1.", k)
        k = re.sub(r"\.conv\.conv\.", ".conv.", k)  # doubly-nested conv
        # resnet inner list counts ELUs at even slots: block.{1,3} → block.{0,1}
        k = re.sub(r"\.block\.(\d+)\.",
                   lambda m: f".block.{int(m.group(1)) // 2}.", k)
        if ".lstm." in k:
            # torch nn.LSTM naming → per-layer {wx, wh, bias}; (4H, D) → (D, 4H)
            k = re.sub(r"lstm\.weight_ih_l(\d+)", r"lstm.\1.wx", k)
            k = re.sub(r"lstm\.weight_hh_l(\d+)", r"lstm.\1.wh", k)
            k = re.sub(r"lstm\.bias_ih_l(\d+)", r"lstm.\1.bias_ih", k)
            k = re.sub(r"lstm\.bias_hh_l(\d+)", r"lstm.\1.bias_hh", k)
            # mlx naming
            k = re.sub(r"\.lstm\.(\d+)\.Wx$", r".lstm.\1.wx", k)
            k = re.sub(r"\.lstm\.(\d+)\.Wh$", r".lstm.\1.wh", k)
            if k.endswith((".wx", ".wh")):
                out[k] = t_linear(w)
            else:
                out[k] = w
            continue
        if "quantizer" in k:
            # quantizer.layers.N.codebook.embed → quantizer.N.embed; drop EMA
            # bookkeeping (embed_avg, cluster_size, inited)
            k = re.sub(r"quantizer\.layers\.(\d+)\.codebook\.embed$",
                       r"quantizer.\1.embed", k)
            if k.endswith(".embed"):
                out[k] = w
            continue
        if k.endswith(".weight") and w.ndim == 3:
            base = k[: -len(".weight")]
            # decoder transposed convs: torch (in, out, k); regular (out, in, k)
            if _is_convtr_key(k, dec_spec):
                out[base + ".kernel"] = t_convtr1d(w)
            else:
                out[base + ".kernel"] = t_conv1d(w)
        elif k.endswith(".weight"):
            out[k[: -len(".weight")] + ".scale"] = w
        else:
            out[k] = w
    # merge split lstm biases (torch keeps ih/hh separately; the cell adds them)
    merged = {}
    for k, w in list(out.items()):
        if k.endswith(".bias_ih"):
            base = k[: -len(".bias_ih")]
            merged[base + ".bias"] = w + out[base + ".bias_hh"]
    out = {k: w for k, w in out.items() if not k.endswith((".bias_ih", ".bias_hh"))}
    out.update(merged)
    return out


def _is_convtr_key(key: str, dec_spec) -> bool:
    m = re.search(r"^decoder\.(\d+)\.", key)
    if not m:
        return False
    idx = int(m.group(1))
    return idx < len(dec_spec) and dec_spec[idx][0] == "convtr"
