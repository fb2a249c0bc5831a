"""Flash-attention backward: CUDA kernels E (dQ) and F (dK, dV) and their
plain version.

The kernels (csrc/flash_attention_bwd.cu, sm_90a: wgmma fed by TMA rings)
replace the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
flux_generator_tpu/ops/pallas/flash_attention.py. Both take the RoPE-ROTATED
q and k, v, the output gradient, the forward's logsumexp lse and dvec =
rowsum(dO ∘ O); the rotation and its pull-back happen outside, in the
autograd function of flash_attention.py. `flash_attention_bwd` dispatches on
the tensors' device only: CPU tensors go to `flash_attention_bwd_reference`,
CUDA tensors to the two kernels, which raise for shapes, dtypes or layouts
they do not take (TMA takes 16-byte aligned bases and strides). There is no
fallback from one to the other.

A block owns 128 rows of one (batch, head), a unit, and a kernel runs one
block an SM: the units of a short last wave are split into parts of their
tile loop (`split_plan`), whose f32 sums the last part to finish adds up in
a fixed order, so the result is deterministic. In
`flash_attention_bwd`, F is launched as E's programmatic dependent, so that
its first blocks fill the SMs that E's last round leaves idle.

Layout: q, k, v, do (B, L, H, D); lse, dvec (B·H, L) f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of each CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
dq_launches = 0
dkv_launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/flash_attention_bwd.cu"
REPLACES_DQ = "flux_generator_tpu/ops/pallas/flash_attention.py:438"
REPLACES_DKV = "flux_generator_tpu/ops/pallas/flash_attention.py:452"
HEAD_DIMS = (64, 128)
ROWS = 128        # rows a block owns: queries in E, keys in F
KEY_TILE = 64     # keys a tile of E's loop
QUERY_TILE = 64   # queries a tile of F's loop
CONSUMERS = 256   # threads that hold a block's accumulators
# The fewest parts a split unit is cut into. Summing the parts costs time
# (their f32 sums go through L2), and in `flash_attention_bwd` F's blocks
# already fill E's last round, so a split pays only when the last wave is
# short; scripts/prof_flash_bwd.py times the pair with 2 parts or more, with
# MIN_PARTS or more, and whole (its readings are in PERF.md §6).
MIN_PARTS = 5

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, do, lse, dvec, dq, partial, tickets, B, L, H, D, scale, full_blocks, chunks, stream
    "fgt_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I,
                                   _P],
    # q, k, v, do, lse, dvec, dk, dv, partial, tickets, B, L, H, D, scale, full_blocks, chunks, after_dq, stream
    "fgt_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                                    _I, _I, _P],
    # D, which (0 E, 1 F), &registers, &spill bytes, &shared memory, &blocks an SM
    "fgt_flash_bwd_info": [_I, _I, _P, _P, _P, _P],
}


def split_plan(units: int, n_tiles: int, sms: int, min_parts: int = MIN_PARTS) -> tuple:
    """(full_blocks, chunks) for `units` blocks of one an SM on `sms` SMs,
    each a loop of `n_tiles` tiles: the whole waves run one block a unit, and
    when the last, partial wave is short enough to go in `min_parts` or more
    parts of the loop a unit, its units run in as many parts as fill the SMs
    (chunks 1: no split). At L 1536, 24 heads and 132 SMs: 288 units = 2
    waves and 24, whose 24-tile loops go in 5 parts, so the third round takes
    about a fifth of a unit's time."""
    waves, rest = divmod(units, sms)
    chunks = min(sms // rest, n_tiles) if rest else 1
    return (units, 1) if chunks < min_parts else (waves * sms, chunks)


def _plan(shape, tile: int, device, split: bool) -> tuple:
    b, l, h, _ = shape
    units = -(-l // ROWS) * b * h
    if not split:
        return units, 1
    return split_plan(units, -(-l // tile), torch.cuda.get_device_properties(device).multi_processor_count)


def _split_units(shape, plan) -> int:
    b, l, h, _ = shape
    return 0 if plan[1] == 1 else -(-l // ROWS) * b * h - plan[0]


def _split_buffers(shape, device, specs):
    """For each (plan, accumulators) of `specs`: f32 scratch for the parts
    of the split units (each part's 256 consumer threads' D/2 sums of each
    accumulator) and their zeroed int32 part counters, or (None, None)
    without a split. The counters come from one fill, made before any
    launch."""
    counts = [_split_units(shape, plan) for plan, _ in specs]
    flat = torch.zeros(sum(counts), dtype=torch.int32, device=device) if sum(counts) else None
    out, at = [], 0
    for (plan, accumulators), n in zip(specs, counts):
        if not n:
            out.append((None, None))
            continue
        partial = torch.empty(accumulators * n * plan[1] * CONSUMERS * (shape[3] // 2), dtype=torch.float32,
                              device=device)
        out.append((partial, flat[at:at + n]))
        at += n
    return out


def _ptr(x):
    return None if x is None else x.data_ptr()


def flash_attention_bwd_reference(qr, kr, v, do, lse, dvec, scale: float):
    """Plain PyTorch version of the two kernels → (dq, dk, dv), each (B, L,
    H, D) in q's dtype, gradients with respect to the rotated q and k.

    The TPU kernels' math in f32: P = exp(q·kᵀ·scale − lse), dP = dO·vᵀ,
    dS = P ∘ (dP − dvec); dq = dS·k·scale, dk = dSᵀ·q·scale, dv = Pᵀ·dO."""
    b, l, h, _ = qr.shape
    qf, kf, vf, of = qr.float(), kr.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.reshape(b, h, l, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", of, vf)
    ds = p * (dp - dvec.reshape(b, h, l, 1))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, of)
    dt = qr.dtype
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_cuda_args(qr, kr, v, do, lse, dvec):
    tensors = (qr, kr, v, do)
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise ValueError("flash backward kernels take bf16 q/k/v/do, got "
                         + "/".join(str(x.dtype) for x in tensors))
    if qr.dim() != 4 or any(x.shape != qr.shape for x in tensors):
        raise ValueError("flash backward kernels take equal (B, L, H, D) q/k/v/do, got "
                         + "/".join(str(tuple(x.shape)) for x in tensors))
    b, l, h, d = qr.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash backward kernels take head dim {HEAD_DIMS}, got {d}")
    for name, x in (("lse", lse), ("dvec", dvec)):
        if x.dtype != torch.float32 or x.shape != (b * h, l):
            raise ValueError(f"{name} must be (B·H, L) = {(b * h, l)} f32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    from .flash_attention import _check_aligned  # that module imports this one

    _check_aligned(*tensors)  # TMA: 16-byte aligned bases and strides
    if not all(x.is_contiguous() for x in (*tensors, lse, dvec)):
        raise ValueError("flash backward kernels take contiguous tensors")
    if any(x.device != qr.device for x in (*tensors, lse, dvec)):
        raise ValueError("all flash backward operands must lie on one device")


def _launch_dq(qr, kr, v, do, lse, dvec, scale, plan, partial, tickets):
    global dq_launches
    b, l, h, d = qr.shape
    lib = _build.load("flash_attention_bwd", _SIGNATURES)
    dq = torch.empty_like(qr)
    with torch.cuda.device(qr.device):
        err = lib.fgt_flash_attention_bwd_dq(
            qr.data_ptr(), kr.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), _ptr(partial), _ptr(tickets), b, l, h, d, float(scale), *plan,
            torch.cuda.current_stream(qr.device).cuda_stream)
    _build.check("fgt_flash_attention_bwd_dq", err)
    dq_launches += 1
    return dq


def _launch_dkv(qr, kr, v, do, lse, dvec, scale, plan, partial, tickets, after_dq: bool):
    global dkv_launches
    b, l, h, d = qr.shape
    lib = _build.load("flash_attention_bwd", _SIGNATURES)
    dk = torch.empty_like(kr)
    dv = torch.empty_like(v)
    with torch.cuda.device(qr.device):
        err = lib.fgt_flash_attention_bwd_dkv(
            qr.data_ptr(), kr.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(partial), _ptr(tickets), b, l, h, d, float(scale), *plan,
            int(after_dq), torch.cuda.current_stream(qr.device).cuda_stream)
    _build.check("fgt_flash_attention_bwd_dkv", err)
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd_dq_cuda(qr, kr, v, do, lse, dvec, scale, *, split: bool = True):
    """Kernel E alone → dq (B, L, H, D) bf16. split=False runs the last,
    partial wave's units whole (one block each), for measuring the tail."""
    _check_cuda_args(qr, kr, v, do, lse, dvec)
    plan = _plan(qr.shape, KEY_TILE, qr.device, split)
    ((partial, tickets),) = _split_buffers(qr.shape, qr.device, [(plan, 1)])
    return _launch_dq(qr, kr, v, do, lse, dvec, scale, plan, partial, tickets)


def flash_attention_bwd_dkv_cuda(qr, kr, v, do, lse, dvec, scale, *, split: bool = True):
    """Kernel F alone → (dk, dv), each (B, L, H, D) bf16; `split` as for E."""
    _check_cuda_args(qr, kr, v, do, lse, dvec)
    plan = _plan(qr.shape, QUERY_TILE, qr.device, split)
    ((partial, tickets),) = _split_buffers(qr.shape, qr.device, [(plan, 2)])
    return _launch_dkv(qr, kr, v, do, lse, dvec, scale, plan, partial, tickets, after_dq=False)


def flash_attention_bwd(qr, kr, v, do, lse, dvec, scale: float):
    """(dq, dk, dv) with respect to the rotated q and k: kernels E and F on
    CUDA tensors, the plain version on CPU tensors. F is launched as E's
    programmatic dependent, right after it, so F's first blocks take the SMs
    that E's last round leaves idle; F ends only once E has. F runs beside E,
    so the scratch of both is made before E and held until F is launched:
    nothing E uses is freed for F's allocations to take."""
    if qr.device.type == "cuda":
        _check_cuda_args(qr, kr, v, do, lse, dvec)
        plan_e = _plan(qr.shape, KEY_TILE, qr.device, True)
        plan_f = _plan(qr.shape, QUERY_TILE, qr.device, True)
        (part_e, tick_e), (part_f, tick_f) = _split_buffers(qr.shape, qr.device, [(plan_e, 1), (plan_f, 2)])
        dq = _launch_dq(qr, kr, v, do, lse, dvec, scale, plan_e, part_e, tick_e)
        return (dq, *_launch_dkv(qr, kr, v, do, lse, dvec, scale, plan_f, part_f, tick_f, after_dq=True))
    if qr.device.type == "cpu":
        return flash_attention_bwd_reference(qr, kr, v, do, lse, dvec, scale)
    raise ValueError(f"no flash attention backward for device {qr.device}")


def kernel_info(d: int = 128) -> dict:
    """Registers a thread at launch, spilled bytes a thread, shared memory a
    block and blocks an SM of kernels E ("dq") and F ("dkv") at head dim d (on
    the current CUDA device)."""
    lib = _build.load("flash_attention_bwd", _SIGNATURES)
    out = {}
    for which, name in enumerate(("dq", "dkv")):
        vals = [ctypes.c_int(0) for _ in range(4)]
        _build.check("fgt_flash_bwd_info", lib.fgt_flash_bwd_info(d, which, *(ctypes.byref(x) for x in vals)))
        out[name] = dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))
    return out
