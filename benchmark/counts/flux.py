"""Operations and bytes of a Flux txt2img request, from the configuration's
shapes (`benchmark/configs/flux-schnell.json`). Every product counts
2·M·N·K; elementwise work, norms and softmax are not counted."""

from __future__ import annotations


def denoise_flops(flow: dict, l_img: int, l_txt: int):
    """(dense, attention) operations of one flow forward over one image:
    each matrix product with its own token count (the double blocks' image
    products see l_img tokens, their text products l_txt, the single blocks
    and every attention both), modulations and embedders left out."""
    h = flow["hidden_size"]
    mlp = int(h * flow["mlp_ratio"])
    s = l_img + l_txt
    per_stream = 2 * h * 3 * h + 2 * h * h + 4 * h * mlp
    double = (l_img + l_txt) * per_stream
    single = 2 * s * h * (3 * h + mlp) + 2 * s * (h + mlp) * h
    attn = 4 * s * s * h
    dense = flow["depth"] * double + flow["depth_single_blocks"] * single
    return dense, (flow["depth"] + flow["depth_single_blocks"]) * attn


def t5_flops(t5: dict, length: int) -> float:
    """The T5 encoder over `length` tokens."""
    d, inner, ff = t5["d_model"], t5["num_heads"] * t5["d_kv"], t5["d_ff"]
    ffn = (6 if t5["feed_forward_proj"].startswith("gated") else 4) * length * d * ff
    return t5["num_layers"] * (8 * length * d * inner + 4 * length * length * inner + ffn)


def clip_flops(clip: dict, length: int) -> float:
    """The CLIP text encoder over `length` tokens (fc1 4·d wide)."""
    d = clip["model_dims"]
    return clip["num_layers"] * (24 * length * d * d + 4 * length * length * d)


def vae_decode_flops(ae: dict, h: int, w: int) -> float:
    """The VAE decoder from an (h, w) latent: 3×3 convs, 1×1 shortcuts and
    the mid block's single-head attention."""
    ch, mult, z = ae["ch"], ae["ch_mult"], ae["z_channels"]
    hw = h * w
    c = ch * mult[-1]

    def conv(cin, cout, px, k=9):
        return 2 * k * cin * cout * px

    def resnet(cin, cout, px):
        return conv(cin, cout, px) + conv(cout, cout, px) + (conv(cin, cout, px, 1) if cin != cout else 0)

    total = conv(z, c, hw) + 2 * resnet(c, c, hw) + 4 * 2 * hw * c * c + 4 * hw * hw * c
    for i in reversed(range(len(mult))):
        out = ch * mult[i]
        for _ in range(ae["num_res_blocks"] + 1):
            total += resnet(c, out, hw)
            c = out
        if i != 0:
            hw *= 4
            total += conv(c, c, hw)
    return total + conv(c, ae["out_ch"], hw)


def image_flops(cfg: dict, width: int, height: int, steps: int, clip_tokens: int) -> float:
    """All the products one image of a request needs: T5 over its padded
    tokens, CLIP over its own, `steps` flow forwards and the decode."""
    h, w = height // 8, width // 8
    dense, attn = denoise_flops(cfg["flow"], h * w // 4, cfg["t5_max_length"])
    return (t5_flops(cfg["t5"], cfg["t5_max_length"]) + clip_flops(cfg["clip"], clip_tokens)
            + steps * (dense + attn) + vae_decode_flops(cfg["ae"], h, w))


def attention_launch(b: int, length: int, heads: int, dim: int):
    """(operations, bytes) of one attention forward: q·kᵀ and p·v; q, k, v
    read and o written once in bf16, the f32 log-sum-exp written."""
    return 4 * b * heads * length * length * dim, 8 * b * length * heads * dim + 4 * b * heads * length


def rope_launch(b: int, length: int, heads: int, dim: int):
    """(operations, bytes) of the RoPE pre-pass: q and k read and written in
    bf16, the bf16 cos and sin tables read; six operations a pair."""
    return 6 * b * length * heads * dim, 8 * b * length * heads * dim + 2 * b * length * dim
