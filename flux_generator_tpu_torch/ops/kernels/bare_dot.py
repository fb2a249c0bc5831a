"""The bare-dot probe (#13): CUDA kernel and plain version.

The kernel (csrc/bare_dot.cu, sm_90a) replaces the TPU kernel `_dot_kernel`
of scripts/prof_attn_int8.py, the probe that separates the cost of the int8
matrix unit from the cost of quantizing inside a kernel. For a (steps·BM, K)
and b (K, steps·BN) it computes out[i·BM:(i+1)·BM] = a_blk(i) · b_blk(i) in
bf16, a_blk(i) being rows i·BM.. of a and b_blk(i) columns i·BN.. of b, in
three modes:

  "bf16"              bf16 in, f32 sums;
  "int8"              int8 in, int32 sums → f32 → bf16;
  "int8_quant_inside" bf16 in; each a row and each b column quantized over K
                      (s = max(amax, 1e-20)/127, rint(x/s) clipped to ±127),
                      then (f32(int32 dot)·s_a)·s_b → bf16.

The division by 127 is taken as XLA compiles the TPU script's `/ 127.0`, a
multiplication by f32(1/127) (PyTorch's CUDA division by a scalar does the
same); x / s is an IEEE division.

On the card every mode runs a persistent wgmma kernel fed by TMA (it needs
16-byte aligned operands). "bf16" walks 128 × 128 output tiles; the int8
modes swap the product's roles, since Hopper's int8 wgmma takes K-major
operands only and b is MN-major: a block keeps a 128-column tile of b as
int8 A fragments in registers and walks the step's row tiles of a, the
K-major B operand. "int8_quant_inside" runs in thread-block clusters of
`cluster_size(bn)` blocks, one a column tile of a step, which quantize each
a row once for the whole cluster (through distributed shared memory) and
each b column once: each a row is quantized BN / 128 / `cluster_size(bn)`
times a step (once at the probe's BN 1024), each b column once.

`bare_dot` dispatches on the inputs' device only: CPU tensors go to
`bare_dot_reference`, CUDA tensors to the kernel, which raises for what it
does not take. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel since the last reset, by mode (the plain
# version on CPU tensors does not count).
launches = {"bf16": 0, "int8": 0, "int8_quant_inside": 0}

SOURCE = "flux_generator_tpu_torch/csrc/bare_dot.cu"
REPLACES = "scripts/prof_attn_int8.py:76"
MODES = ("bf16", "int8", "int8_quant_inside")
TILE = 128  # output rows and columns per block
K_RANGE = (32, 256)  # the kernel stages the whole K of a tile in shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fgt_bare_dot": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fgt_bare_dot_info": [_I, _I, _P, _P, _P, _P, _P],
    "fgt_bare_dot_plan": [_I, _I, _I, _I, _I, _P, _P],
}
MAX_CLUSTER = 8  # "int8_quant_inside": blocks a cluster at most (the portable limit)


def _quant(x: torch.Tensor, dim: int):
    """int8 levels (as f64) and f32 scales of f32 x over `dim`: the TPU
    script's `_quant_rows`, its s = max(amax, 1e-20) / 127 as the product
    with f32(1/127) that XLA compiles it to."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-20) * (1.0 / 127.0)
    return torch.clamp(torch.round(x / s), -127, 127).double(), s


def cluster_size(bn: int) -> int:
    """Blocks a cluster of the "int8_quant_inside" kernel: the largest divisor
    of the column tiles a step (BN / 128) up to MAX_CLUSTER."""
    tiles = bn // TILE
    return next(c for c in range(min(MAX_CLUSTER, tiles), 0, -1) if tiles % c == 0)


def _steps(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int) -> int:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bare dot takes a (steps·BM, K) and b (K, steps·BN), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    steps = a.shape[0] // bm
    if steps < 1 or a.shape[0] != steps * bm or b.shape[1] != steps * bn:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} are not {steps} steps of "
                         f"({bm}, K) and (K, {bn}) blocks")
    return steps


def bare_dot_reference(a: torch.Tensor, b: torch.Tensor, mode: str, bm: int = 1024,
                       bn: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function → (steps·BM, BN) bf16.
    Integer dots are taken in f64, which holds them exactly."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    steps = _steps(a, b, bm, bn)
    k = a.shape[1]
    a3 = a.reshape(steps, bm, k)
    b3 = b.reshape(k, steps, bn).permute(1, 0, 2)
    if mode == "bf16":
        out = torch.bmm(a3.float(), b3.float())
    elif mode == "int8":
        out = torch.bmm(a3.double(), b3.double()).float()
    else:
        ai, sa = _quant(a3.float(), 2)
        bi, sb = _quant(b3.float(), 1)
        out = torch.bmm(ai, bi).float() * sa * sb
    return out.to(torch.bfloat16).reshape(steps * bm, bn)


def _check_cuda_args(a, b, mode, bm, bn):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    want = torch.int8 if mode == "int8" else torch.bfloat16
    if a.dtype != want or b.dtype != want:
        raise ValueError(f"bare dot {mode!r} takes {want} operands, got {a.dtype}/{b.dtype}")
    _steps(a, b, bm, bn)
    k = a.shape[1]
    if k % 32 or not K_RANGE[0] <= k <= K_RANGE[1]:
        raise ValueError(f"bare dot kernel takes K a multiple of 32 in {K_RANGE}, got {k}")
    if bm % TILE or bn % TILE:
        raise ValueError(f"bare dot kernel takes BM, BN multiples of {TILE}, got {bm}, {bn}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bare dot kernel takes contiguous operands")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("bare dot kernel takes 16-byte aligned operands (TMA, cp.async)")
    if b.device != a.device:
        raise ValueError("a and b must lie on one device")


def _bare_dot_cuda(a, b, mode, bm, bn):
    _check_cuda_args(a, b, mode, bm, bn)
    steps = a.shape[0] // bm
    lib = _build.load("bare_dot", _SIGNATURES)
    out = torch.empty((steps * bm, bn), dtype=torch.bfloat16, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.fgt_bare_dot(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1], bm, bn, steps,
                               MODES.index(mode), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("fgt_bare_dot", err)
    launches[mode] += 1
    return out


def kernel_info(mode: str, k: int = 128) -> dict:
    """A mode's kernel at K: registers a thread at launch, local memory
    (spill) bytes a thread, shared memory bytes a block, blocks an SM, ring
    stages."""
    lib = _build.load("bare_dot", _SIGNATURES)
    vals = [ctypes.c_int() for _ in range(5)]
    _build.check("fgt_bare_dot_info",
                 lib.fgt_bare_dot_info(MODES.index(mode), k, *(ctypes.byref(v) for v in vals)))
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm", "stages"), (v.value for v in vals)))


def plan(mode: str, k: int, bm: int, bn: int, steps: int) -> dict:
    """An int8 mode's launch on the current card: blocks in the grid, blocks
    a cluster."""
    lib = _build.load("bare_dot", _SIGNATURES)
    grid, cluster = ctypes.c_int(), ctypes.c_int()
    _build.check("fgt_bare_dot_plan", lib.fgt_bare_dot_plan(MODES.index(mode), k, bm, bn, steps,
                                                            ctypes.byref(grid), ctypes.byref(cluster)))
    return dict(grid=grid.value, cluster=cluster.value)


def bare_dot(a: torch.Tensor, b: torch.Tensor, mode: str, bm: int = 1024, bn: int = 1024) -> torch.Tensor:
    """out[i·BM:(i+1)·BM] = a_blk(i) · b_blk(i) in bf16 (see the module
    docstring for the modes)."""
    if a.device.type == "cuda":
        return _bare_dot_cuda(a, b, mode, bm, bn)
    if a.device.type == "cpu":
        return bare_dot_reference(a, b, mode, bm, bn)
    raise ValueError(f"no bare dot for device {a.device}")
