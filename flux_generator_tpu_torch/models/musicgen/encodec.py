"""EnCodec neural audio codec (counterpart of
flux_generator_tpu/models/musicgen/encodec.py).

SEANet encoder and decoder with asymmetric reflect-padded convs, the 2-layer
LSTM bottleneck of each (kernel C on CUDA tensors, ops/kernels/lstm.py),
transposed convs, residual vector quantization (encode: the nearest code of
each residual in turn; decode: the sum of the codes' vectors), the chunked
encode and decode protocols (decode with linear overlap-add) and audio
preprocessing (pad to a chunk boundary, with its mask). Layer sequences come from config as static specs, and init
builds both halves, so the param tree matches the JAX one: convs (k, in,
out) HIO with a bias, LSTM {wx, wh (d, 4d), bias (4d,)} with gate order
(i, f, g, o), quantizer codebooks (codebook_size, codebook_dim).

Activations are (B, T, C). The JAX decode runs as two jitted programs split
after the LSTM only to fit the TPU's VMEM; here it is one eager pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.kernels.lstm import lstm
from ...ops.linear import _rand_uniform, conv1d, conv_transpose1d
from ...ops.norms import group_norm
from ...runtime.device import as_device, make_generator


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    audio_channels: int = 1
    num_filters: int = 64
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    upsampling_ratios: Sequence[int] = (8, 5, 4, 4)
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    num_lstm_layers: int = 2
    hidden_size: int = 128
    codebook_size: int = 2048
    codebook_dim: int = 128
    compress: int = 2
    use_causal_conv: bool = False
    pad_mode: str = "reflect"
    norm_type: str = "weight_norm"
    trim_right_ratio: float = 1.0
    sampling_rate: int = 32000
    target_bandwidths: Sequence[float] = (2.2,)
    chunk_length_s: Optional[float] = None
    overlap: Optional[float] = None
    normalize: bool = False
    use_conv_shortcut: bool = False

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsampling_ratios))

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sampling_rate / self.hop_length)

    @property
    def codebook_nbits(self) -> int:
        return math.ceil(math.log2(self.codebook_size))

    @property
    def num_quantizers(self) -> int:
        return int(1000 * self.target_bandwidths[-1] // (self.frame_rate * self.codebook_nbits))

    @property
    def chunk_length(self) -> Optional[int]:
        if self.chunk_length_s is None:
            return None
        return int(self.chunk_length_s * self.sampling_rate)

    @property
    def chunk_stride(self) -> Optional[int]:
        if self.chunk_length_s is None or self.overlap is None:
            return None
        return max(1, int((1.0 - self.overlap) * self.chunk_length))


def tiny_encodec_config(**overrides) -> EncodecConfig:
    base = dict(
        num_filters=4,
        upsampling_ratios=(4, 2),
        num_lstm_layers=1,
        hidden_size=8,
        codebook_size=16,
        codebook_dim=8,
        target_bandwidths=(0.8,),
        sampling_rate=800,
    )
    base.update(overrides)
    return EncodecConfig(**base)


# ------------------------------------------------------------ layer specs
# ("conv", cin, cout, k, stride, dilation) | ("convtr", cin, cout, k, stride)
# | ("resnet", dim, (d1, d2)) | ("lstm", dim) | ("elu",)


def encoder_spec(cfg: EncodecConfig) -> List[tuple]:
    spec = [("conv", cfg.audio_channels, cfg.num_filters, cfg.kernel_size, 1, 1)]
    scaling = 1
    for ratio in reversed(list(cfg.upsampling_ratios)):
        cur = scaling * cfg.num_filters
        for j in range(cfg.num_residual_layers):
            spec.append(("resnet", cur, (cfg.dilation_growth_rate**j, 1)))
        spec.append(("elu",))
        spec.append(("conv", cur, cur * 2, ratio * 2, ratio, 1))
        scaling *= 2
    spec.append(("lstm", scaling * cfg.num_filters))
    spec.append(("elu",))
    spec.append(("conv", scaling * cfg.num_filters, cfg.hidden_size, cfg.last_kernel_size, 1, 1))
    return spec


def decoder_spec(cfg: EncodecConfig) -> List[tuple]:
    scaling = int(2 ** len(cfg.upsampling_ratios))
    spec = [("conv", cfg.hidden_size, scaling * cfg.num_filters, cfg.kernel_size, 1, 1)]
    spec.append(("lstm", scaling * cfg.num_filters))
    for ratio in cfg.upsampling_ratios:
        cur = scaling * cfg.num_filters
        spec.append(("elu",))
        spec.append(("convtr", cur, cur // 2, ratio * 2, ratio))
        for j in range(cfg.num_residual_layers):
            spec.append(("resnet", cur // 2, (cfg.dilation_growth_rate**j, 1)))
        scaling //= 2
    spec.append(("elu",))
    spec.append(("conv", cfg.num_filters, cfg.audio_channels, cfg.last_kernel_size, 1, 1))
    return spec


# ------------------------------------------------------------ init


def _init_conv1d_p(g, cin, cout, k, dtype, device):
    scale = 1.0 / math.sqrt(cin * k)
    return {"kernel": _rand_uniform((k, cin, cout), scale, dtype, device, g),
            "bias": _rand_uniform((cout,), scale, dtype, device, g)}


def _init_lstm_p(g, dim, dtype, device):
    scale = 1.0 / math.sqrt(dim)
    return {"wx": _rand_uniform((dim, 4 * dim), scale, dtype, device, g),
            "wh": _rand_uniform((dim, 4 * dim), scale, dtype, device, g),
            "bias": _rand_uniform((4 * dim,), scale, dtype, device, g)}


def _norm_p(cout, dtype, device):
    return {"scale": torch.ones((cout,), dtype=dtype, device=device),
            "bias": torch.zeros((cout,), dtype=dtype, device=device)}


def _init_layer(g, entry, cfg: EncodecConfig, dtype, device):
    kind = entry[0]
    if kind in ("conv", "convtr"):
        cin, cout, k = entry[1], entry[2], entry[3]
        p = {"conv": _init_conv1d_p(g, cin, cout, k, dtype, device)}
        if cfg.norm_type == "time_group_norm":
            p["norm"] = _norm_p(cout, dtype, device)
        return p
    if kind == "resnet":
        _, dim, _ = entry
        hidden = dim // cfg.compress
        p = {"block": [
            {"conv": _init_conv1d_p(g, dim, hidden, cfg.residual_kernel_size, dtype, device)},
            {"conv": _init_conv1d_p(g, hidden, dim, 1, dtype, device)},
        ]}
        if cfg.use_conv_shortcut:
            p["shortcut"] = {"conv": _init_conv1d_p(g, dim, dim, 1, dtype, device)}
        return p
    if kind == "lstm":
        return {"lstm": [_init_lstm_p(g, entry[1], dtype, device)
                         for _ in range(cfg.num_lstm_layers)]}
    if kind == "elu":
        return {}
    raise ValueError(kind)


def init_encodec(generator: torch.Generator, cfg: EncodecConfig, dtype=torch.float32, device=None):
    """Random encoder + decoder + quantizer params in the JAX tree layout,
    drawn from `generator` (the streams differ from jax.random's)."""
    return {
        "encoder": [_init_layer(generator, e, cfg, dtype, device) for e in encoder_spec(cfg)],
        "decoder": [_init_layer(generator, e, cfg, dtype, device) for e in decoder_spec(cfg)],
        "quantizer": [
            {"embed": torch.randn((cfg.codebook_size, cfg.codebook_dim), generator=generator,
                                  device=device, dtype=torch.float32).to(dtype)}
            for _ in range(cfg.num_quantizers)
        ],
    }


# ------------------------------------------------------------ primitives


def lstm_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer over x (B, T, D): the input projection x·Wx + b as one
    matmul, then the recurrence (kernel C on CUDA tensors, its plain version
    on CPU ones; gate order (i, f, g, o), states in f32)."""
    return lstm(p, x)


def _pad1d(x: torch.Tensor, pad: Tuple[int, int], mode: str) -> torch.Tensor:
    """Pad the time axis of (B, T, C). Reflect padding is built by hand, as in
    the JAX package: the right side clamps its start at 0, so a pad as long
    as the input is allowed (F.pad's reflect refuses it)."""
    left, right = pad
    if mode != "reflect":
        return F.pad(x, (0, 0, left, right))
    length = x.shape[1]
    parts = []
    if left > 0:
        parts.append(x[:, 1:left + 1].flip(1))
    parts.append(x)
    if right > 0:
        parts.append(x[:, max(length - right - 1, 0):length - 1].flip(1))
    return torch.cat(parts, dim=1)


def _enc_conv(p, cfg: EncodecConfig, x, k, stride, dilation):
    eff_k = (k - 1) * dilation + 1
    pad_total = k - stride
    length = x.shape[1]
    n_frames = math.ceil((length - eff_k + pad_total) / stride + 1) - 1
    ideal = n_frames * stride + eff_k - pad_total
    extra = ideal - length
    if cfg.use_causal_conv:
        x = _pad1d(x, (pad_total, extra), cfg.pad_mode)
    else:
        pr = pad_total // 2
        x = _pad1d(x, (pad_total - pr, pr + extra), cfg.pad_mode)
    y = conv1d(p["conv"], x, stride, dilation=dilation)
    if "norm" in p:
        y = group_norm(y, p["norm"], groups=1)
    return y


def _dec_convtr(p, cfg: EncodecConfig, x, k, stride):
    """The transposed conv over a kernel time-flipped at load (HIO), then
    pl/pr trimmed off."""
    y = conv_transpose1d(p["conv"], x, stride)
    if "norm" in p:
        y = group_norm(y, p["norm"], groups=1)
    pad_total = k - stride
    if cfg.use_causal_conv:
        pr = math.ceil(pad_total * cfg.trim_right_ratio)
    else:
        pr = pad_total // 2
    pl = pad_total - pr
    return y[:, pl:y.shape[1] - pr]


def _resnet(p, cfg: EncodecConfig, x, dilations):
    y = x
    for blk, k, d in zip(p["block"], (cfg.residual_kernel_size, 1), dilations):
        y = F.elu(y, alpha=1.0)
        y = _enc_conv(blk, cfg, y, k, 1, d)
    if "shortcut" in p:
        x = _enc_conv(p["shortcut"], cfg, x, 1, 1, 1)
    return x + y


def _run_spec(params, spec, cfg: EncodecConfig, x):
    for p, entry in zip(params, spec):
        kind = entry[0]
        if kind == "conv":
            x = _enc_conv(p, cfg, x, entry[3], entry[4], entry[5])
        elif kind == "convtr":
            x = _dec_convtr(p, cfg, x, entry[3], entry[4])
        elif kind == "resnet":
            x = _resnet(p, cfg, x, entry[2])
        elif kind == "lstm":
            h = x
            for lp in p["lstm"]:
                h = lstm_forward(lp, h)
            x = x + h
        elif kind == "elu":
            x = F.elu(x, alpha=1.0)
    return x


def rvq_encode(quantizer, embeddings: torch.Tensor, num_quantizers: int) -> torch.Tensor:
    """embeddings (B, T, D) → codes (B, nq, T): at each of the first
    `num_quantizers` codebooks the nearest code to the residual by squared
    distance (|r|² − 2 r·e + |e|², the first index on a tie), whose vector
    is then taken off the residual."""
    residual = embeddings
    codes = []
    for layer in quantizer[:num_quantizers]:
        embed = layer["embed"].to(embeddings.dtype)  # (K, D)
        dist = ((residual ** 2).sum(-1, keepdim=True) - 2 * residual @ embed.t()
                + (embed ** 2).sum(-1))
        idx = dist.argmin(dim=-1)
        codes.append(idx)
        residual = residual - embed[idx]
    return torch.stack(codes, dim=1)


def rvq_decode(quantizer, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, nq, T) → summed codebook vectors (B, T, D)."""
    out = None
    for i in range(codes.shape[1]):
        q = quantizer[i]["embed"][codes[:, i]]
        out = q if out is None else out + q
    return out


# ------------------------------------------------------------ model API


class EncodecModel:
    def __init__(self, cfg: EncodecConfig, params: dict):
        self.cfg = cfg
        self.params = params
        self._enc_spec = encoder_spec(cfg)
        self._dec_spec = decoder_spec(cfg)

    @classmethod
    def random_init(cls, cfg: Optional[EncodecConfig] = None, generator=None,
                    dtype=torch.float32, device=None):
        """Random params on `device`, drawn from `generator` (seed 0 on
        `device` when None); with neither given, on the current CUDA device,
        raising where there is none."""
        cfg = cfg or tiny_encodec_config()
        device = as_device(device if device is not None
                           else (generator.device if generator is not None else None))
        generator = generator if generator is not None else make_generator(device, 0)
        return cls(cfg, init_encodec(generator, cfg, dtype, device))

    def num_quantizers_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        bw_per_q = math.log2(self.cfg.codebook_size) * self.cfg.frame_rate
        if bandwidth is not None and bandwidth > 0:
            return max(1, math.floor(bandwidth * 1000 / bw_per_q))
        return self.cfg.num_quantizers

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's output before quantization: (B, T, C) audio →
        (B, frames, hidden)."""
        return _run_spec(self.params["encoder"], self._enc_spec, self.cfg, x)

    def _encode_frame(self, x, mask, nq: int):
        scale = None
        if self.cfg.normalize:
            x = x * mask[..., None]
            mono = x.sum(dim=2, keepdim=True) / x.shape[2]
            scale = torch.sqrt((mono ** 2).mean(dim=1, keepdim=True)) + 1e-8
            x = x / scale
        return rvq_encode(self.params["quantizer"], self.embed(x), nq), scale

    def encode(self, input_values: torch.Tensor, padding_mask=None, bandwidth: Optional[float] = None):
        """input_values (B, T, C) → (codes (frames, B, nq, T'), [scale of each
        frame, or None]): the chunked protocol (one frame when the config
        has no chunk length), at `bandwidth` (the first target bandwidth
        when None). Raises for a bandwidth the config does not list, for
        other than 1 or 2 channels, and for input not padded to the chunk
        stride (preprocess_audio pads it)."""
        if bandwidth is None:
            bandwidth = self.cfg.target_bandwidths[0]
        if bandwidth not in self.cfg.target_bandwidths:
            raise ValueError(f"unsupported bandwidth {bandwidth}; pick from {self.cfg.target_bandwidths}")
        nq = self.num_quantizers_for_bandwidth(bandwidth)
        _, length, channels = input_values.shape
        if not 1 <= channels <= 2:
            raise ValueError("audio must have 1 or 2 channels")
        chunk_length = self.cfg.chunk_length or length
        stride = self.cfg.chunk_stride or length
        if padding_mask is None:
            padding_mask = torch.ones(input_values.shape[:2], dtype=torch.bool, device=input_values.device)
        step = chunk_length - stride
        if (length % stride) != step:
            raise ValueError("input not padded for chunked encoding")
        frames, scales = [], []
        for offset in range(0, length - step, stride):
            codes, scale = self._encode_frame(input_values[:, offset:offset + chunk_length],
                                              padding_mask[:, offset:offset + chunk_length], nq)
            frames.append(codes)
            scales.append(scale)
        return torch.stack(frames), scales

    def _decode_frame(self, codes, scale=None):
        emb = rvq_decode(self.params["quantizer"], codes)
        audio = _run_spec(self.params["decoder"], self._dec_spec, self.cfg, emb)
        if scale is not None:
            audio = audio * scale
        return audio

    @staticmethod
    def _linear_overlap_add(frames, stride: int):
        n, frame_length, c = frames[0].shape
        total = stride * (len(frames) - 1) + frames[-1].shape[1]
        t = np.linspace(0, 1, frame_length + 2)[1:-1]
        weight = torch.from_numpy((0.5 - np.abs(t - 0.5))[:, None].astype(np.float32))
        weight = weight.to(frames[0].device, frames[0].dtype)
        out = torch.zeros((n, total, c), dtype=frames[0].dtype, device=frames[0].device)
        sum_w = torch.zeros((total, 1), dtype=frames[0].dtype, device=frames[0].device)
        offset = 0
        for frame in frames:
            fl = frame.shape[1]
            out[:, offset:offset + fl] += weight[:fl] * frame
            sum_w[offset:offset + fl] += weight[:fl]
            offset += stride
        return out / sum_w

    def decode(self, audio_codes, audio_scales, padding_mask=None):
        """audio_codes (frames, B, nq, T) → waveform (B, T', C)."""
        if self.cfg.chunk_length is None:
            if audio_codes.shape[0] != 1:
                raise ValueError("expected one frame")
            audio = self._decode_frame(audio_codes[0], audio_scales[0])
        else:
            decoded = [self._decode_frame(f, s) for f, s in zip(audio_codes, audio_scales)]
            audio = self._linear_overlap_add(decoded, self.cfg.chunk_stride or 1)
        if padding_mask is not None and padding_mask.shape[1] < audio.shape[1]:
            audio = audio[:, :padding_mask.shape[1]]
        return audio


def preprocess_audio(raw_audio, sampling_rate=24000, chunk_length=None, chunk_stride=None):
    """Pad a waveform, or a list of them ((T,) or (T, C), arrays or tensors),
    to the longest (and then to a chunk boundary when `chunk_length` is
    given) → (audio (B, T, C), mask (B, T) bool) as CPU tensors; 64-bit
    audio comes back in 32 bits, as the JAX package's arrays do."""
    if not isinstance(raw_audio, list):
        raw_audio = [raw_audio]
    raw_audio = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in raw_audio]
    raw_audio = [x[..., None] if x.ndim == 1 else x for x in raw_audio]
    max_length = max(x.shape[0] for x in raw_audio)
    if chunk_length is not None:
        max_length += chunk_length - (max_length % chunk_stride)
    inputs, masks = [], []
    for x in raw_audio:
        mask = np.ones(x.shape[0], bool)
        diff = max_length - x.shape[0]
        if diff > 0:
            mask = np.pad(mask, (0, diff))
            x = np.pad(x, ((0, diff), (0, 0)))
        inputs.append(x.astype({np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}.get(x.dtype, x.dtype)))
        masks.append(mask)
    return (torch.stack([torch.from_numpy(np.ascontiguousarray(x)) for x in inputs]),
            torch.stack([torch.from_numpy(m) for m in masks]))
