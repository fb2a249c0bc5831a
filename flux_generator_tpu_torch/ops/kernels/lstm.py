"""LSTM recurrence: CUDA kernel (kernel C) and plain version.

The kernel (csrc/lstm.cu, sm_90a) replaces the TPU kernel `_lstm_kernel` of
flux_generator_tpu/ops/pallas/lstm.py, with the contract of `lstm_pallas`:
the input projection xw = x·Wx + b is one matmul outside the kernel, cast to
the recurrent weight's dtype (bf16 when 16·d² > 4 Mi, as for EnCodec's
d = 1024, else f32); per step gates = xw_t + (h cast to that dtype)·Wh with
f32 accumulation, gate order (i, f, g, o), c and h kept in f32, output h in
x's dtype. `lstm` dispatches on the tensors' device only: CPU tensors go to
`lstm_plain`, CUDA tensors to the kernel, which raises for inputs it does
not take (a block whose Wh columns and h do not fit the card's shared
memory: d past about 1600 in bf16 on an H100). There is no fallback from
one to the other.

The kernel is one cooperative launch: a warp a hidden unit, Wh resident on
chip (in registers where d ≤ 1024 and a block has at most 8 units, else in
shared memory: `lstm_geometry`), xw read RING (step, batch) pairs ahead,
and h exchanged across the grid as flagged 8-byte words {value, step tag}
in `_words`, zeroed each call, instead of a grid barrier. `phase_times`
splits its step; `exchange_floor` runs its serial floor, the exchanges
alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/lstm.cu"
REPLACES = "flux_generator_tpu/ops/pallas/lstm.py:105"
MAX_REG_D = 1024  # a lane holds its unit's four Wh columns in registers up to 32 rows each
MAX_REG_UNITS = 8  # units (warps) a block with Wh in registers
MAX_UNITS = 16  # units a block with Wh in shared memory (the kernel's launch bound: 512 threads)
RING = 8  # (step, batch) pairs of xw each warp keeps ahead in shared memory (the kernel's RING)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xw, wh, out, words, B, T, d, units, kpl, wh_is_bf16, out_is_bf16, mode, timers, stream
    "fgt_lstm_recurrence": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
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


@functools.lru_cache(maxsize=None)
def lstm_geometry(d: int, sms: int) -> tuple:
    """The kernel's launch for width d on a card of `sms` SMs → (units,
    kpl): `units` = ⌈d / sms⌉ hidden units a block (a warp each), so that
    the grid of ⌈d / units⌉ blocks fits one block an SM; `kpl` the rows of
    Wh a lane holds a column in registers (8, 16 or 32, 32·kpl ≥ d) where
    d ≤ 1024 and units ≤ 8, else 0: the block's Wh columns stay in shared
    memory (d 1024 on a card of fewer than 128 SMs, or d > 1024)."""
    units = -(-d // sms)
    if units > MAX_UNITS:
        raise ValueError(f"the LSTM kernel takes at most {MAX_UNITS} units a block, so d ≤ {MAX_UNITS * sms} "
                         f"on {sms} SMs, not {d}")
    if d <= MAX_REG_D and units <= MAX_REG_UNITS:
        return units, next(k for k in (8, 16, 32) if 32 * k >= d)
    return units, 0


_RUN, _PHASES, _FLOOR = 0, 1, 2


def _words(b: int, d: int, kpl: int, device) -> torch.Tensor:
    """The flagged h words of one call, zeroed (tags start at 1): two
    parities of B rows of d 8-byte words, each row rounded up to a multiple
    of 4, or with Wh in registers (kpl > 0) and B > 1 to the 32·kpl rows a
    lane's reads of h span (the kernel's `wpitch_h`)."""
    pitch = 32 * kpl if kpl and b > 1 else -(-d // 4) * 4
    return torch.zeros(2 * b * pitch, dtype=torch.int64, device=device)


def _launch(xw, wh, out, b, t, d, mode, timers, device, geometry=None):
    """One launch on `device` at `geometry` (units, kpl; by default the
    card's own, `lstm_geometry`), counted."""
    global launches
    lib = _build.load("lstm", _SIGNATURES)
    with torch.cuda.device(device):
        units, kpl = geometry or lstm_geometry(d, _build.sm_count(torch.cuda.current_device()))
        words = _words(b, d, 0 if mode == _FLOOR else kpl, device)  # the serial floor lays words out as kpl 0
        err = lib.fgt_lstm_recurrence(
            0 if xw is None else xw.data_ptr(), 0 if wh is None else wh.data_ptr(),
            0 if out is None else out.data_ptr(), words.data_ptr(), b, t, d, units, kpl,
            int(wh is not None and wh.dtype == torch.bfloat16), int(out is not None and out.dtype == torch.bfloat16),
            mode, 0 if timers is None else timers.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.check(f"fgt_lstm_recurrence (B {b}, d {d}, {units} units a block, Wh in "
                 f"{'registers' if kpl else 'shared memory'}; a block's Wh columns and h must fit shared memory)",
                 err)
    launches += 1


def _run(xw, wh, out_dtype, mode=_RUN, timers=None, geometry=None):
    """The kernel on CUDA tensors → h (B, T, d) in `out_dtype`."""
    _check_cuda_args(xw, wh, out_dtype)
    b, t, _ = xw.shape
    d = wh.shape[0]
    if xw.data_ptr() % 4:  # the xw ring copies 4-byte words
        xw = xw.clone()
    out = torch.empty((b, t, d), dtype=out_dtype, device=xw.device)
    _launch(xw, wh, out, b, t, d, mode, timers, xw.device, geometry)
    return out


PHASE_NAMES = ("xw ring", "h exchange", "matvec", "gates")


def phase_times(xw: torch.Tensor, wh: torch.Tensor) -> dict:
    """One launch of the kernel on CUDA tensors with block 0's thread 0
    reading the device clock between the phases of each step → {phase name:
    µs a step}: the xw ring's read, the wait for h_{t-1} (the exchange across
    the grid, and the slowest block), warp 0's matvec, its gates and the
    publishing of its h. The launch counts."""
    timers = torch.zeros(len(PHASE_NAMES), dtype=torch.int64, device=xw.device)
    _run(xw, wh, torch.float32, _PHASES, timers)
    per_step = (timers.double() / 1e3 / xw.shape[1]).cpu().tolist()
    return dict(zip(PHASE_NAMES, per_step))


def exchange_floor(b: int, t: int, d: int, device) -> None:
    """The kernel's serial floor on CUDA `device`: T exchanges of flagged h
    words across the grid of a (B, T, d) recurrence, with no gate math. The
    launch counts."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the serial floor runs the CUDA kernel, not on {device}")
    _launch(None, None, None, b, t, d, _FLOOR, None, device)


def lstm_recurrence(xw: torch.Tensor, wh: torch.Tensor, out_dtype) -> torch.Tensor:
    """The recurrence alone, dispatched on the device of xw."""
    if xw.device.type == "cuda":
        return _run(xw, wh, out_dtype)
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, wh, out_dtype)
    raise ValueError(f"no LSTM for device {xw.device}")


def lstm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer: x (B, T, D_in) → hidden states (B, T, d) in x's dtype."""
    xw, wh = _project(p, x)
    return lstm_recurrence(xw, wh, x.dtype)
