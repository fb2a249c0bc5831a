"""Plain float32 operations of the reference, and the lower precisions its
control runs in.

Weights arrive as the seeded tensors that the benchmark drew and handed to
the program (bf16 for the models, f32 for EnCodec) and are widened to f32 a block at a time.
`Precision("f32")` computes everything in f32; "fp8" rounds both operands
of every dense and conv product to e4m3 (weights scaled per output
channel, activations per tensor), the step below bf16; "bf16" rounds them
to bf16, the step below f32 with TF32 allowed. Norms, softmax and the
sampler's arithmetic stay in f32 in every precision. TF32 is switched off
while the reference runs (`no_tf32`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def _round(self, x, channel_dim=None):
        if self.name == "f32":
            return x
        if self.name == "bf16":
            return x.to(torch.bfloat16).float()
        if channel_dim is None:
            amax = x.abs().amax()
        else:
            dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
            amax = x.abs().amax(dim=dims, keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def act(self, x):
        """An activation entering a product."""
        return self._round(x.float())

    def weight(self, w, out_dim: int = -1):
        """A weight entering a product; `out_dim` is its output-channel axis."""
        return self._round(w.float(), out_dim)


F32 = Precision("f32")


@contextlib.contextmanager
def no_tf32():
    """Full f32 products while the reference runs; the previous flags after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def f32(tree):
    """A nested dict / list of tensors widened to f32 (a copy)."""
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [f32(v) for v in tree]
    return tree.float()


def layer(tree, i: int):
    """Layer i of a tree whose leaves are stacked on a leading axis, in f32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def dense(p, x, prec: Precision = F32):
    """x (..., in) @ kernel (in, out) + bias."""
    y = prec.act(x) @ prec.weight(p["kernel"], -1)
    if "bias" in p:
        y = y + p["bias"].float()
    return y


def layer_norm(x, p=None, eps: float = 1e-5):
    x = x.float()
    y = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, keepdim=True, unbiased=False) + eps)
    if p is not None:
        y = y * p["scale"].float() + (p["bias"].float() if "bias" in p else 0.0)
    return y


def rms_norm(x, p=None, eps: float = 1e-6):
    x = x.float()
    y = x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps)
    return y * p["scale"].float() if p is not None else y


def group_norm(x, p, groups: int, eps: float = 1e-5):
    """GroupNorm over channel-last (B, ..., C) activations."""
    shape = x.shape
    g = x.float().reshape(shape[0], -1, groups, shape[-1] // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(shape)
    return y * p["scale"].float() + p["bias"].float()


def attention(q, k, v, bias=None, mask=None, scale=None, heads_at_once: int = 8):
    """softmax(q·kᵀ·scale + bias)·v over (B, L, H, D) in f32, a few heads at a
    time so that the logits of a long sequence fit. mask: True attends,
    broadcastable to (B, H, Lq, Lk)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    q, k, v = q.float(), k.float(), v.float()
    outs = []
    for h0 in range(0, q.shape[2], heads_at_once):
        hs = slice(h0, h0 + heads_at_once)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, :, hs], k[:, :, hs]) * scale
        if bias is not None:
            logits = logits + bias[:, hs].float() if bias.shape[1] > 1 else logits + bias.float()
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v[:, :, hs]))
        del logits
    return torch.cat(outs, dim=2)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def conv2d(p, x, prec: Precision = F32, stride: int = 1, padding: int = 1):
    """x (B, H, W, C) NHWC, kernel (kh, kw, in, out) HWIO."""
    w = prec.weight(p["kernel"], -1).permute(3, 2, 0, 1)
    y = F.conv2d(prec.act(x).permute(0, 3, 1, 2), w, p["bias"].float(), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv1d(p, x, prec: Precision = F32, stride: int = 1, dilation: int = 1):
    """x (B, T, C), kernel (k, in, out) HIO, no padding."""
    w = prec.weight(p["kernel"], -1).permute(2, 1, 0)
    return F.conv1d(prec.act(x).transpose(1, 2), w, p["bias"].float(), stride=stride,
                    dilation=dilation).transpose(1, 2)


def conv_transpose1d(p, x, prec: Precision = F32, stride: int = 1):
    """The transposed 1-D conv with the kernel (k, in, out) stored time-flipped."""
    w = prec.weight(p["kernel"], -1).flip(0).permute(1, 2, 0)
    return F.conv_transpose1d(prec.act(x).transpose(1, 2), w, p["bias"].float(),
                              stride=stride).transpose(1, 2)


def sinusoid(t, dim: int, max_period: float = 10000.0, time_factor: float = 1000.0):
    """Flux's timestep embedding: [cos | sin] of t·factor over dim/2 frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = time_factor * t.float()[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
