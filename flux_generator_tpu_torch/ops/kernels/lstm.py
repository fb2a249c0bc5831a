"""LSTM recurrence: CUDA kernel (kernel C) and plain version.

The kernel (csrc/lstm.cu, sm_90a) replaces the TPU kernel `_lstm_kernel` of
flux_generator_tpu/ops/pallas/lstm.py, with the contract of `lstm_pallas`:
the input projection xw = x·Wx + b is one matmul outside the kernel, cast to
the recurrent weight's dtype (bf16 when 16·d² > 4 Mi, as for EnCodec's
d = 1024, else f32); per step gates = xw_t + (h cast to that dtype)·Wh with
f32 accumulation, gate order (i, f, g, o), c and h kept in f32, output h in
x's dtype. `lstm` dispatches on the tensors' device only: CPU tensors go to
`lstm_plain`, CUDA tensors to the kernel, which raises for inputs it does
not take. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/lstm.cu"
REPLACES = "flux_generator_tpu/ops/pallas/lstm.py:105"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xw, wh, out, hbuf, B, T, d, wh_is_bf16, out_is_bf16, stream
    "fgt_lstm_recurrence": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def wh_dtype_for(d: int) -> torch.dtype:
    """Storage dtype of the recurrent weight and of xw: f32 while Wh
    (16·d² bytes in f32) is at most 4 MiB, else bf16 (lstm.py:96)."""
    return torch.float32 if 4 * d * 4 * d <= 4 * 1024 * 1024 else torch.bfloat16


def _project(p: dict, x: torch.Tensor):
    """(xw (B, T, 4d), Wh (d, 4d)), both in the recurrence's dtype."""
    wd = wh_dtype_for(p["wh"].shape[0])
    xw = (x @ p["wx"].to(x.dtype) + p["bias"].to(x.dtype)).to(wd)
    return xw.contiguous(), p["wh"].to(wd).contiguous()


def lstm_recurrence_plain(xw: torch.Tensor, wh: torch.Tensor, out_dtype) -> torch.Tensor:
    """Plain version of the kernel: xw (B, T, 4d) and wh (d, 4d) in one
    dtype → h (B, T, d) in `out_dtype`."""
    b, t, _ = xw.shape
    d = wh.shape[0]
    whf = wh.float()
    h = torch.zeros((b, d), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    out = torch.empty((b, t, d), dtype=out_dtype, device=xw.device)
    for i in range(t):
        gates = xw[:, i].float() + h.to(wh.dtype).float() @ whf
        gi, gf, gg, go = gates.split(d, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        out[:, i] = h.to(out_dtype)
    return out


def lstm_plain(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the whole layer: x (B, T, D_in) → h (B, T, d)."""
    xw, wh = _project(p, x)
    return lstm_recurrence_plain(xw, wh, x.dtype)


def _check_cuda_args(xw, wh, out_dtype):
    if wh.dtype not in (torch.float32, torch.bfloat16) or xw.dtype != wh.dtype:
        raise ValueError(f"LSTM kernel takes f32 or bf16 xw/wh of one dtype, got {xw.dtype}/{wh.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"LSTM kernel writes f32 or bf16, not {out_dtype}")
    if wh.dim() != 2 or wh.shape[1] != 4 * wh.shape[0]:
        raise ValueError(f"Wh must be (d, 4d), got {tuple(wh.shape)}")
    if xw.dim() != 3 or xw.shape[2] != wh.shape[1]:
        raise ValueError(f"xw must be (B, T, 4d) with 4d = {wh.shape[1]}, got {tuple(xw.shape)}")
    if not (xw.is_contiguous() and wh.is_contiguous()):
        raise ValueError("LSTM kernel takes contiguous xw and Wh")
    if xw.device != wh.device:
        raise ValueError("xw and Wh must lie on one device")


def _lstm_recurrence_cuda(xw, wh, out_dtype):
    global launches
    _check_cuda_args(xw, wh, out_dtype)
    b, t, _ = xw.shape
    d = wh.shape[0]
    lib = _build.load("lstm", _SIGNATURES)
    out = torch.empty((b, t, d), dtype=out_dtype, device=xw.device)
    hbuf = torch.empty((2, b, d), dtype=torch.float32, device=xw.device)
    with torch.cuda.device(xw.device):
        err = lib.fgt_lstm_recurrence(
            xw.data_ptr(), wh.data_ptr(), out.data_ptr(), hbuf.data_ptr(), b, t, d,
            int(wh.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(xw.device).cuda_stream,
        )
    _build.check("fgt_lstm_recurrence", err)
    launches += 1
    return out


def lstm_recurrence(xw: torch.Tensor, wh: torch.Tensor, out_dtype) -> torch.Tensor:
    """The recurrence alone, dispatched on the device of xw."""
    if xw.device.type == "cuda":
        return _lstm_recurrence_cuda(xw, wh, out_dtype)
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, wh, out_dtype)
    raise ValueError(f"no LSTM for device {xw.device}")


def lstm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer: x (B, T, D_in) → hidden states (B, T, d) in x's dtype."""
    xw, wh = _project(p, x)
    return lstm_recurrence(xw, wh, x.dtype)
