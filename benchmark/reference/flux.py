"""Flux text-to-image in plain f32 (FLUX.1's published design): T5 and CLIP
conditioning, the MMDiT flow (double-stream blocks over text and image
tokens, then single-stream blocks, AdaLN modulation, QK-RMSNorm, 3-axis
RoPE on interleaved pairs), the flow-matching Euler steps on schnell's
linear schedule, and the 16-channel VAE decoder to uint8 pixels.

Each request is worked out from what the client sent (prompt, seed, size,
steps): the tokens by the reference tokenizers, the prior by drawing the
seed's normal noise as the served path draws it (a `torch.Generator` on
the card seeded with the request's seed, f32 draws rounded to bf16), the
positions and the schedule from the size and step count. Weights are the
seeded tensors the benchmark drew and handed to the program, widened a
block at a time.
"""

from __future__ import annotations

import torch

from .ops import F32, Precision, attention, conv2d, dense, gelu_tanh, group_norm, layer, layer_norm, rms_norm, sinusoid
from .text import clip_pooled, t5_encode


def _rope(ids, axes_dim, theta: float):
    """ids (B, L, 3) → (cos, sin) (B, L, D/2) f32, one table per axis."""
    cos, sin = [], []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d)
        ang = ids[..., i].float()[..., None] * omega
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def _rotate(x, cos, sin):
    """x (B, L, H, D): pairs (2i, 2i+1) rotated by the angle of column i."""
    e, o = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, :, None], sin[:, :, None]
    return torch.stack([e * c - o * s, e * s + o * c], dim=-1).flatten(-2)


def _heads(x, hd):
    return x.reshape(*x.shape[:2], -1, hd)


def _qkv(p, x, hd, prec):
    q, k, v = dense(p["qkv"], x, prec).chunk(3, dim=-1)
    return rms_norm(_heads(q, hd), p["q_norm"]), rms_norm(_heads(k, hd), p["k_norm"]), _heads(v, hd)


def _attend(q, k, v, cos, sin):
    return attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v)


def _mod(p, vec, n, prec):
    return dense(p, torch.nn.functional.silu(vec), prec)[:, None].chunk(3 * n, dim=-1)


def flow(params, cfg: dict, img, img_ids, txt, txt_ids, t, y, prec: Precision = F32):
    """The flow's velocity for packed latents img (B, L, 64), T5 features txt
    (B, S, 4096), pooled CLIP y (B, 768) and timesteps t (B,) → (B, L, 64)."""
    hd = cfg["hidden_size"] // cfg["num_heads"]
    silu = torch.nn.functional.silu
    img = dense(params["img_in"], img, prec)
    te = params["time_in"]
    vec = dense(te["out_layer"], silu(dense(te["in_layer"], sinusoid(t, 256), prec)), prec)
    ve = params["vector_in"]
    vec = vec + dense(ve["out_layer"], silu(dense(ve["in_layer"], y, prec)), prec)
    txt = dense(params["txt_in"], txt, prec)
    cos, sin = _rope(torch.cat([txt_ids, img_ids], dim=1), cfg["axes_dim"], float(cfg["theta"]))
    s = txt.shape[1]
    for i in range(cfg["depth"]):
        p = layer(params["double_blocks"], i)
        im = _mod(p["img_mod"], vec, 2, prec)
        tm = _mod(p["txt_mod"], vec, 2, prec)
        iq, ik, iv = _qkv(p["img_attn"], (1 + im[1]) * layer_norm(img, eps=1e-6) + im[0], hd, prec)
        tq, tk, tv = _qkv(p["txt_attn"], (1 + tm[1]) * layer_norm(txt, eps=1e-6) + tm[0], hd, prec)
        a = _attend(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1), torch.cat([tv, iv], 1), cos, sin).flatten(2)
        img = img + im[2] * dense(p["img_attn"]["proj"], a[:, s:], prec)
        h = (1 + im[4]) * layer_norm(img, eps=1e-6) + im[3]
        img = img + im[5] * dense(p["img_mlp"]["out"], gelu_tanh(dense(p["img_mlp"]["in"], h, prec)), prec)
        txt = txt + tm[2] * dense(p["txt_attn"]["proj"], a[:, :s], prec)
        h = (1 + tm[4]) * layer_norm(txt, eps=1e-6) + tm[3]
        txt = txt + tm[5] * dense(p["txt_mlp"]["out"], gelu_tanh(dense(p["txt_mlp"]["in"], h, prec)), prec)
        del p
    x = torch.cat([txt, img], dim=1)
    width = cfg["hidden_size"]
    for i in range(cfg["depth_single_blocks"]):
        p = layer(params["single_blocks"], i)
        shift, scale, gate = _mod(p["modulation"], vec, 1, prec)
        proj = dense(p["linear1"], (1 + scale) * layer_norm(x, eps=1e-6) + shift, prec)
        q, k, v = proj[..., :3 * width].chunk(3, dim=-1)
        a = _attend(rms_norm(_heads(q, hd), p["q_norm"]), rms_norm(_heads(k, hd), p["k_norm"]),
                    _heads(v, hd), cos, sin).flatten(2)
        x = x + gate * dense(p["linear2"], torch.cat([a, gelu_tanh(proj[..., 3 * width:])], dim=-1), prec)
        del p, proj
    fl = params["final_layer"]
    shift, scale = dense(fl["adaLN"], silu(vec), prec).chunk(2, dim=-1)
    x = (1 + scale[:, None]) * layer_norm(x[:, s:], eps=1e-6) + shift[:, None]
    return dense(fl["linear"], x, prec)


# ------------------------------------------------------------ VAE decoder


def _groups(x) -> int:
    """GroupNorm's 32 groups, or one a channel below 32 channels."""
    return min(32, x.shape[-1])


def _resnet(p, x, prec):
    h = conv2d(p["conv1"], torch.nn.functional.silu(group_norm(x, p["norm1"], _groups(x), 1e-6)), prec)
    h = conv2d(p["conv2"], torch.nn.functional.silu(group_norm(h, p["norm2"], _groups(h), 1e-6)), prec)
    return (dense(p["nin_shortcut"], x, prec) if "nin_shortcut" in p else x) + h


def _mid_attention(p, x, prec):
    b, hh, ww, c = x.shape
    y = group_norm(x.reshape(b, hh * ww, c), p["norm"], _groups(x), 1e-6)
    q, k, v = (dense(p[m], y, prec)[:, :, None] for m in "qkv")
    return x + dense(p["proj_out"], attention(q, k, v, heads_at_once=1)[:, :, 0], prec).reshape(b, hh, ww, c)


def vae_decode(params, cfg: dict, z, prec: Precision = F32):
    """Latents (B, h, w, z) → images (B, 8h, 8w, 3) in about [-1, 1], one
    image at a time."""
    out = []
    for zi in z:
        p = params["decoder"]
        h = conv2d(p["conv_in"], (zi[None].float() / cfg["scale_factor"] + cfg["shift_factor"]), prec)
        h = _resnet(p["mid"]["block_1"], h, prec)
        h = _mid_attention(p["mid"]["attn_1"], h, prec)
        h = _resnet(p["mid"]["block_2"], h, prec)
        for lvl in reversed(p["up"]):
            for blk in lvl["block"]:
                h = _resnet(blk, h, prec)
            if "upsample" in lvl:
                h = conv2d(lvl["upsample"], h.repeat_interleave(2, 1).repeat_interleave(2, 2), prec)
        h = torch.nn.functional.silu(group_norm(h, p["norm_out"], _groups(h), 1e-6))
        out.append(conv2d(p["conv_out"], h, prec))
    return torch.cat(out)


def to_uint8(img):
    """[-1, 1] images → uint8 RGB, as a server writes them: (x + 1) / 2
    clamped to [0, 1], times 255, truncated."""
    return (torch.clamp((img + 1) * 0.5, 0, 1) * 255).to(torch.uint8)


# ------------------------------------------------------------ a request


def prior(seed: int, n_images: int, h: int, w: int, z: int, device):
    """The prior of image j of a request: normal draws from a generator on
    `device` seeded with seed + j, rounded to bf16 as the served weights'
    dtype holds them → (n, h, w, z) f32."""
    out = []
    for j in range(n_images):
        g = torch.Generator(device=device).manual_seed(int(seed) + j)
        out.append(torch.randn((1, h, w, z), generator=g, device=device, dtype=torch.float32)
                   .to(torch.bfloat16).float())
    return torch.cat(out)


def _pack(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(b, h * w // 4, 4 * c)


def _unpack(x, h, w):
    return x.reshape(x.shape[0], h // 2, w // 2, -1, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(x.shape[0], h, w, -1)


def generate(weights, cfg: dict, tokenizers, prompt: str, seed: int, n_images: int, width: int,
             height: int, steps: int, prec: Precision = F32):
    """A txt2img request → uint8 images (n, H, W, 3) on the weights' device."""
    device = weights["flow"]["img_in"]["kernel"].device
    t5_tok, clip_tok = tokenizers
    h, w = height // 8, width // 8  # the server's latent size (sides are multiples of 16)
    t5 = torch.tensor([t5_tok.encode(prompt)], device=device)
    clip = torch.tensor([clip_tok.encode(prompt)], device=device)
    txt = t5_encode(weights["t5"], cfg["t5"], t5, prec).expand(n_images, -1, -1)
    vec = clip_pooled(weights["clip"], cfg["clip"], clip, prec).expand(n_images, -1)
    x = _pack(prior(seed, n_images, h, w, cfg["ae"]["z_channels"], device))
    j, k = torch.meshgrid(torch.arange(h // 2, device=device), torch.arange(w // 2, device=device), indexing="ij")
    img_ids = torch.stack([torch.zeros_like(j), j, k], -1).reshape(1, -1, 3).expand(n_images, -1, -1)
    txt_ids = torch.zeros((n_images, txt.shape[1], 3), device=device)
    ts = torch.linspace(1.0, 0.0, steps + 1).tolist()
    for t, t_next in zip(ts[:-1], ts[1:]):
        v = flow(weights["flow"], cfg["flow"], x, img_ids, txt, txt_ids,
                 torch.full((n_images,), t, device=device), vec, prec)
        x = x + (t_next - t) * v
    return to_uint8(vae_decode(weights["ae"], cfg["ae"], _unpack(x, h, w), prec))
