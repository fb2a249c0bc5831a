"""The seeded weights of a run, drawn by the benchmark itself.

Each model's tree is described here from the configuration file's numbers
alone: every leaf's path, shape and draw. `draw` makes the whole tree on
the device from the run's seed in a few large calls, in the type it is
served in: one buffer, filled with U(-1, 1) by one generator, then each
leaf a view of it scaled to its own range. The same tree is handed to the
program's constructors and read by the plain reference, so neither side
reads weights that the other made.

The trees follow the layout the pipelines' constructors take (layers
stacked on a leading axis, q/k/v fused where the model fuses them, convs
as (k, in, out), transposed convs stored time-flipped); the reference
works out everything else from them. The draws follow the usual inits:
dense and conv kernels and biases U(±1/√fan_in), embedding tables and
relative biases with std 0.02, EnCodec's codebooks with std 1, norm scales
1 ± 0.1 and norm biases ± 0.05 (so that a norm's affine part is read).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

ALIGN = 128  # elements between leaf starts: 256-byte aligned views in bf16


@dataclass(frozen=True)
class Leaf:
    shape: tuple
    bound: float  # half-width of the uniform draw
    center: float = 0.0


def uniform(shape, fan_in: int) -> Leaf:
    return Leaf(tuple(shape), 1.0 / math.sqrt(fan_in))


def normal(shape, std: float) -> Leaf:
    """A draw of standard deviation `std` (uniform, of that spread)."""
    return Leaf(tuple(shape), std * math.sqrt(3.0))


def norm(d: int, bias: bool = True) -> dict:
    out = {"scale": Leaf((d,), 0.1, 1.0)}
    if bias:
        out["bias"] = Leaf((d,), 0.05)
    return out


def dense(n_in: int, n_out: int, bias: bool = True) -> dict:
    out = {"kernel": uniform((n_in, n_out), n_in)}
    if bias:
        out["bias"] = uniform((n_out,), n_in)
    return out


def conv(cin: int, cout: int, k, dims: int = 2) -> dict:
    shape = (k,) * dims
    fan_in = cin * k ** dims
    return {"kernel": uniform((*shape, cin, cout), fan_in), "bias": uniform((cout,), fan_in)}


def stacked(n: int, tree):
    """The tree of one layer with each leaf stacked n deep."""
    if isinstance(tree, dict):
        return {k: stacked(n, v) for k, v in tree.items()}
    return Leaf((n, *tree.shape), tree.bound, tree.center)


def leaves(spec):
    """(path, Leaf) in the tree's order."""
    if isinstance(spec, Leaf):
        yield (), spec
    elif isinstance(spec, dict):
        for k, v in spec.items():
            for path, leaf in leaves(v):
                yield (k, *path), leaf
    else:
        for i, v in enumerate(spec):
            for path, leaf in leaves(v):
                yield (i, *path), leaf


def draw(spec, seed: int, device, dtype, salt: int = 0):
    """The tree of `spec` with every leaf drawn, on `device` in `dtype`, from
    a generator seeded with the run's seed (and `salt`, one a tree)."""
    flat = list(leaves(spec))
    sizes = [-(-math.prod(leaf.shape) // ALIGN) * ALIGN for _, leaf in flat]
    buf = torch.empty(max(1, sum(sizes)), dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed((int(seed) << 4) | salt)
    for chunk in buf.split(1 << 28):
        chunk.uniform_(-1.0, 1.0, generator=g)
    out, offset = [], 0
    for (path, leaf), size in zip(flat, sizes):
        view = buf[offset:offset + math.prod(leaf.shape)].view(leaf.shape)
        view.mul_(leaf.bound)
        if leaf.center:
            view.add_(leaf.center)
        out.append((path, view))
        offset += size
    return _build(spec, dict(out))


def _build(spec, views, prefix=()):
    if isinstance(spec, Leaf):
        return views[prefix]
    if isinstance(spec, dict):
        return {k: _build(v, views, (*prefix, k)) for k, v in spec.items()}
    return [_build(v, views, (*prefix, i)) for i, v in enumerate(spec)]


# ------------------------------------------------------------ text encoders


def t5_encoder(c: dict) -> dict:
    d, inner, ff = c["d_model"], c["d_kv"] * c["num_heads"], c["d_ff"]
    if c["feed_forward_proj"].startswith("gated"):
        mlp = {"wi_0": dense(d, ff, False), "wi_1": dense(d, ff, False), "wo": dense(ff, d, False)}
    else:
        mlp = {"wi": dense(d, ff, False), "wo": dense(ff, d, False)}
    layer = {"ln1": norm(d, bias=False),
             "attention": {"q": dense(d, inner, False), "k": dense(d, inner, False),
                           "v": dense(d, inner, False), "o": dense(inner, d, False)},
             "ln2": norm(d, bias=False), "dense": mlp}
    return {"wte": normal((c["vocab_size"], d), 0.02),
            "encoder": {"layers": stacked(c["num_layers"], layer), "ln": norm(d, bias=False),
                        "rel_bias": normal((c["relative_attention_num_buckets"], c["num_heads"]), 0.02)}}


def clip_text(c: dict) -> dict:
    d = c["model_dims"]
    layer = {"ln1": norm(d), "ln2": norm(d), "q": dense(d, d), "k": dense(d, d), "v": dense(d, d),
             "o": dense(d, d), "fc1": dense(d, 4 * d), "fc2": dense(4 * d, d)}
    out = {"token_embedding": normal((c["vocab_size"], d), 0.02),
           "position_embedding": normal((c["max_length"], d), 0.02),
           "layers": stacked(c["num_layers"], layer), "final_ln": norm(d)}
    if c.get("projection_dim"):
        out["text_projection"] = dense(d, c["projection_dim"], False)
    return out


# ------------------------------------------------------------ Flux


def flux_flow(c: dict) -> dict:
    h = c["hidden_size"]
    mlp, hd = int(h * c["mlp_ratio"]), h // c["num_heads"]

    def embedder(n_in):
        return {"in_layer": dense(n_in, h), "out_layer": dense(h, h)}

    def attn():
        return {"qkv": dense(h, 3 * h, c["qkv_bias"]), "q_norm": norm(hd, bias=False),
                "k_norm": norm(hd, bias=False), "proj": dense(h, h)}

    double = {"img_mod": dense(h, 6 * h), "txt_mod": dense(h, 6 * h), "img_attn": attn(), "txt_attn": attn(),
              "img_mlp": {"in": dense(h, mlp), "out": dense(mlp, h)},
              "txt_mlp": {"in": dense(h, mlp), "out": dense(mlp, h)}}
    single = {"linear1": dense(h, 3 * h + mlp), "linear2": dense(h + mlp, h), "q_norm": norm(hd, bias=False),
              "k_norm": norm(hd, bias=False), "modulation": dense(h, 3 * h)}
    out = {"img_in": dense(c["in_channels"], h), "txt_in": dense(c["context_in_dim"], h),
           "time_in": embedder(256), "vector_in": embedder(c["vec_in_dim"]),
           "double_blocks": stacked(c["depth"], double), "single_blocks": stacked(c["depth_single_blocks"], single),
           "final_layer": {"linear": dense(h, c["in_channels"]), "adaLN": dense(h, 2 * h)}}
    if c["guidance_embed"]:
        out["guidance_in"] = embedder(256)
    return out


def _resnet(cin: int, cout: int) -> dict:
    out = {"norm1": norm(cin), "conv1": conv(cin, cout, 3), "norm2": norm(cout), "conv2": conv(cout, cout, 3)}
    if cin != cout:
        out["nin_shortcut"] = dense(cin, cout)
    return out


def _mid(ch: int) -> dict:
    return {"block_1": _resnet(ch, ch),
            "attn_1": {"norm": norm(ch), **{n: dense(ch, ch) for n in ("q", "k", "v", "proj_out")}},
            "block_2": _resnet(ch, ch)}


def flux_ae(c: dict) -> dict:
    ch, mult, nres = c["ch"], c["ch_mult"], c["num_res_blocks"]
    down, block_in = [], ch
    for i, m in enumerate(mult):
        block_in = ch * ((1,) + tuple(mult))[i]
        blocks = []
        for _ in range(nres):
            blocks.append(_resnet(block_in, ch * m))
            block_in = ch * m
        lvl = {"block": blocks}
        if i != len(mult) - 1:
            lvl["downsample"] = conv(block_in, block_in, 3)
        down.append(lvl)
    encoder = {"conv_in": conv(c["in_channels"], ch, 3), "down": down, "mid": _mid(block_in),
               "norm_out": norm(block_in), "conv_out": conv(block_in, 2 * c["z_channels"], 3)}
    block_in = ch * mult[-1]
    up = [None] * len(mult)
    for i in reversed(range(len(mult))):
        blocks = []
        for _ in range(nres + 1):
            blocks.append(_resnet(block_in, ch * mult[i]))
            block_in = ch * mult[i]
        lvl = {"block": blocks}
        if i != 0:
            lvl["upsample"] = conv(block_in, block_in, 3)
        up[i] = lvl
    decoder = {"conv_in": conv(c["z_channels"], ch * mult[-1], 3), "mid": _mid(ch * mult[-1]), "up": up,
               "norm_out": norm(block_in), "conv_out": conv(block_in, c["out_ch"], 3)}
    return {"encoder": encoder, "decoder": decoder}


def flux(cfg: dict) -> dict:
    return {"flow": flux_flow(cfg["flow"]), "ae": flux_ae(cfg["ae"]), "clip": clip_text(cfg["clip"]),
            "t5": t5_encoder(cfg["t5"])}


# ------------------------------------------------------------ MusicGen


def musicgen_decoder(c: dict) -> dict:
    h, ffn, kb, v = c["hidden_size"], c["ffn_dim"], c["num_codebooks"], c["codebook_size"]
    layer = {"norm1": norm(h), "self_attn": {"qkv": dense(h, 3 * h, False), "o": dense(h, h, False)},
             "norm_cross": norm(h), "cross_attn": {"qkv": dense(h, 3 * h, False), "o": dense(h, h, False)},
             "norm2": norm(h), "linear1": dense(h, ffn, False), "linear2": dense(ffn, h, False)}
    return {"emb": normal((kb, v + 1, h), 0.02), "layers": stacked(c["num_hidden_layers"], layer),
            "out_norm": norm(h), "linears": normal((kb, h, v), 0.02), "text_proj": dense(c["text_d_model"], h)}


def _conv1d(cin: int, cout: int, k: int) -> dict:
    return {"conv": conv(cin, cout, k, dims=1)}


def _seanet_resnet(c: dict, dim: int) -> dict:
    hidden = dim // c["compress"]
    out = {"block": [_conv1d(dim, hidden, c["residual_kernel_size"]), _conv1d(hidden, dim, 1)]}
    if c["use_conv_shortcut"]:
        out["shortcut"] = _conv1d(dim, dim, 1)
    return out


def _lstm(c: dict, d: int) -> dict:
    return {"lstm": [{"wx": uniform((d, 4 * d), d), "wh": uniform((d, 4 * d), d), "bias": uniform((4 * d,), d)}
                     for _ in range(c["num_lstm_layers"])]}


def encodec_quantizers(c: dict) -> int:
    """Codebooks at the configuration's bandwidth: kbit/s over the bits a
    frame of one codebook takes."""
    frame_rate = math.ceil(c["sampling_rate"] / math.prod(c["upsampling_ratios"]))
    return int(1000 * c["target_bandwidths"][-1] // (frame_rate * math.ceil(math.log2(c["codebook_size"]))))


def encodec(c: dict) -> dict:
    """SEANet encoder and decoder as layer lists ({} for an ELU), and the
    residual codebooks."""
    if c["norm_type"] != "weight_norm":
        raise ValueError(f"EnCodec norm {c['norm_type']!r}: only weight_norm (folded into the kernels) is drawn")
    nf, ratios = c["num_filters"], list(c["upsampling_ratios"])
    enc, scaling = [_conv1d(c["audio_channels"], nf, c["kernel_size"])], 1
    for ratio in reversed(ratios):
        cur = scaling * nf
        enc += [_seanet_resnet(c, cur) for _ in range(c["num_residual_layers"])]
        enc += [{}, _conv1d(cur, 2 * cur, 2 * ratio)]
        scaling *= 2
    enc += [_lstm(c, scaling * nf), {}, _conv1d(scaling * nf, c["hidden_size"], c["last_kernel_size"])]
    dec = [_conv1d(c["hidden_size"], scaling * nf, c["kernel_size"]), _lstm(c, scaling * nf)]
    for ratio in ratios:
        cur = scaling * nf
        dec += [{}, _conv1d(cur, cur // 2, 2 * ratio)]
        dec += [_seanet_resnet(c, cur // 2) for _ in range(c["num_residual_layers"])]
        scaling //= 2
    dec += [{}, _conv1d(nf, c["audio_channels"], c["last_kernel_size"])]
    return {"encoder": enc, "decoder": dec,
            "quantizer": [{"embed": normal((c["codebook_size"], c["codebook_dim"]), 1.0)}
                          for _ in range(encodec_quantizers(c))]}
