"""W8A8 matmul with fused activation quantization (kernel G) and the per-row
int8 quantizer (kernel H): CUDA kernels and plain versions.

The kernels (csrc/w8a8_matmul.cu, sm_90a) replace the TPU kernels `_kernel`
and `_quant_kernel` of flux_generator_tpu/ops/pallas/w8a8_matmul.py.
`w8a8_matmul` and `quantize_rows` dispatch on the input's device only: CPU
tensors go to the plain versions, CUDA tensors to the kernels, which raise for
what they do not take. There is no fallback from one to the other.

Weights are the repo's int8 per-channel tier: `kernel_q` (K, N) int8 and
`kernel_scale` (N,) f32. G takes `kernel_q` K-contiguous (strides (1, K)),
the layout in which `ops.quant` stores that tier, and raises for any other.
The activation scale of G is per (row, K block), K cut into blocks of 512, 256 or 128 (the largest that divides K); that of H is
per whole row. Both take sx = max(amax|x|, 1e-12) · (1/127) and
x_q = round(x · (1/sx)) (half to even) with no clip.

G's GEMM runs persistent blocks (`grid`: at most one an SM) over output
tiles of 128 rows × 128 or 192 columns (`tile_n`), each of which folds its K
blocks in order as the plain version does: on the card G equals the plain
version bit for bit. H reads each row from HBM once, whole warps a row with
its chunks in registers (`quantize_geometry`), and equals its plain version
bit for bit too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..quant import is_k_major
from . import _build

# Launches of each CUDA kernel since the last reset (the plain versions on CPU
# tensors do not count).
launches = 0
quantize_launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/w8a8_matmul.cu"
REPLACES = "flux_generator_tpu/ops/pallas/w8a8_matmul.py:119"
REPLACES_QUANTIZE = "flux_generator_tpu/ops/pallas/w8a8_matmul.py:166"
BK_CANDIDATES = (512, 256, 128)
TILE = 128  # rows of G's output tiles
TILE_WIDTHS = (128, 192)  # their columns: the kernel's two instantiations

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, xq, sx, w, ws, out, M, N, K, bn, grid, stream
    "fgt_w8a8_matmul": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        _P],
    "fgt_w8a8_matmul_info": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P],
    # x, xq, sx, M, K, chunks, tpr, rows, blocks, stream
    "fgt_quantize_rows": [_P, _P, _P, *[ctypes.c_int] * 6, _P],
}


def pick_bk(k: int) -> int:
    """The K block of G: the largest candidate dividing K, 0 if none does."""
    return next((bk for bk in BK_CANDIDATES if k % bk == 0), 0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_n(m: int, n: int, sms: int) -> int:
    """Width of G's output tiles (128 rows × 128 or 192 columns) on a card of
    `sms` SMs: the one whose busiest block has the fewest columns to compute,
    ⌈tiles / sms⌉ · width, the wider on a tie (it moves fewer bytes a
    product). Both widths run a column at the same rate on the H100; what
    differs is how evenly the tiles fill the blocks."""
    return min(TILE_WIDTHS[::-1], key=lambda bn: _cdiv(_cdiv(m, TILE) * _cdiv(n, bn), sms) * bn)


def grid(m: int, n: int, sms: int) -> int:
    """Persistent blocks of G's GEMM on a card of `sms` SMs: one an SM (its
    shared memory takes one an SM), no more than there are tiles; block b
    takes tiles b, b + grid, ..."""
    return min(_cdiv(m, TILE) * _cdiv(n, tile_n(m, n, sms)), sms)


def supported(k: int, kernel_scale: torch.Tensor) -> bool:
    """Per-output-channel scales and a K that tiles a block candidate."""
    return kernel_scale.dim() == 1 and pick_bk(k) > 0


def _quantize(xf: torch.Tensor):
    """f32 rows (…, K) → (round(x · (1/sx)) as f32 integers, sx (…, 1))."""
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    return torch.round(xf * torch.reciprocal(sx)), sx


def quantize_rows_reference(x: torch.Tensor):
    """Plain version of H: x (…, K) → int8 (…, K) and f32 scales (…, 1)."""
    q, sx = _quantize(x.float())
    return q.to(torch.int8), sx


def w8a8_matmul_reference(x: torch.Tensor, kernel_q: torch.Tensor,
                          kernel_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of G: x (…, K) → (…, N) in x's dtype. Each K block's
    dot is exact in f32 (|Σ| ≤ 512·127² < 2²⁴); the blocks are folded into
    the f32 accumulator in order, as the kernel does."""
    *lead, k = x.shape
    n = kernel_q.shape[1]
    bk = pick_bk(k)
    if kernel_q.shape[0] != k or not supported(k, kernel_scale):
        raise ValueError(f"W8A8 takes K % 128 == 0 and (N,) scales, got x {tuple(x.shape)}, "
                         f"kernel {tuple(kernel_q.shape)}, scales {tuple(kernel_scale.shape)}")
    nkb = k // bk
    xq, sx = _quantize(x.reshape(-1, nkb, bk).float())       # (M, nkb, bk), (M, nkb, 1)
    dots = torch.matmul(xq.transpose(0, 1), kernel_q.float().reshape(nkb, bk, n))  # (nkb, M, N)
    acc = torch.zeros_like(dots[0])
    for i in range(nkb):
        acc = acc + dots[i] * sx[:, i]
    return (acc * kernel_scale.float()).to(x.dtype).reshape(*lead, n)


def _check_2d(x2: torch.Tensor, what: str):
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bf16 activations, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError(f"{what} takes contiguous activations")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x (…, K) as contiguous (M, K) rows whose start is 16-byte aligned."""
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.contiguous() if not x2.is_contiguous() else x2.clone()
    return x2


def _w8a8_matmul_cuda(x, kernel_q, kernel_scale):
    global launches
    *lead, k = x.shape
    x2 = _rows(x)
    _check_2d(x2, "W8A8 kernel")
    if kernel_q.dtype != torch.int8 or kernel_q.dim() != 2 or kernel_q.shape[0] != k:
        raise ValueError(f"W8A8 kernel takes (K, N) int8 weights for K={k}, got "
                         f"{kernel_q.dtype} {tuple(kernel_q.shape)}")
    n = kernel_q.shape[1]
    if not supported(k, kernel_scale) or kernel_scale.shape[0] != n:
        raise ValueError(f"W8A8 kernel takes K % 128 == 0 and ({n},) scales, got K={k}, "
                         f"scales {tuple(kernel_scale.shape)}")
    if kernel_scale.dtype != torch.float32:
        raise ValueError(f"W8A8 kernel takes f32 scales, got {kernel_scale.dtype}")
    if not is_k_major(kernel_q) or not kernel_scale.is_contiguous():
        raise ValueError(f"W8A8 kernel takes K-contiguous weights (strides (1, {k}), as ops.quant "
                         f"stores them) and contiguous scales, got weight strides {kernel_q.stride()}")
    if kernel_q.data_ptr() % 16:
        raise ValueError("W8A8 kernel takes 16-byte aligned weights")
    if kernel_q.device != x2.device or kernel_scale.device != x2.device:
        raise ValueError("operands must lie on one device")
    m = x2.shape[0]
    lib = _build.load("w8a8_matmul", _SIGNATURES)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # scratch: x quantized per (row, K block), once for all output tiles
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, k // pick_bk(k)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        sms = _build.sm_count(x.device.index)
        err = lib.fgt_w8a8_matmul(x2.data_ptr(), x_q.data_ptr(), sx.data_ptr(), kernel_q.data_ptr(),
                                  kernel_scale.data_ptr(), out.data_ptr(), m, n, k, tile_n(m, n, sms),
                                  grid(m, n, sms), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fgt_w8a8_matmul", err)
    launches += 1
    return out.reshape(*lead, n)


def kernel_info(bk: int = 512, bn: int = 128) -> dict:
    """G's GEMM kernel at K block `bk` and tile width `bn`: registers a thread
    at launch, local memory (spill) bytes a thread, shared memory bytes a
    block, blocks an SM."""
    lib = _build.load("w8a8_matmul", _SIGNATURES)
    vals = [ctypes.c_int() for _ in range(4)]
    _build.check("fgt_w8a8_matmul_info", lib.fgt_w8a8_matmul_info(bk, bn, *(ctypes.byref(v) for v in vals)))
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), (v.value for v in vals)))


H_MAX_THREADS = 512  # a block's most: the kernel's launch bound (2 blocks an SM, 64 registers a thread)
H_BLOCK_THREADS = 256  # short rows share a block up to this many threads
H_SCALAR_ROWS = 8  # rows a block of the scalar kernel (one warp each)
H_REG_VALUES = H_MAX_THREADS * 8 * 8  # the longest row held in registers: 512 threads × 8 chunks of 8


class HGeometry(NamedTuple):
    """H's launch: `route`, `chunks` 16-byte chunks (8 values) a thread,
    `tpr` threads a row, `rows` rows a block, `blocks` blocks."""
    route: str
    chunks: int
    tpr: int
    rows: int
    blocks: int


@functools.lru_cache(maxsize=None)
def quantize_geometry(m: int, k: int, sms: int) -> HGeometry:
    """H's launch for an (m, k) bf16 input on a card of `sms` SMs (asked
    once a shape: H runs 920 times a "rows" request).

    - "registers" (K ≤ 32,768): a thread's chunks stay in registers between
      the amax and the quantize pass, so a row is read from HBM once. With at
      least 4 rows an SM (the activations of Flux's image stream) a thread
      takes the most chunks that waste at most 1/8 of its row's threads, so
      the most rows are in flight on each SM; with fewer rows (the text
      stream's 256) a thread takes the fewest chunks that keep a row within
      512 threads, so each row's loads are spread over the most threads.
      (Both rules are timed by scripts/prof_quantize_rows.py.)
    - "sweep" (longer rows; no Flux or MusicGen activation comes near): the
      amax tile by tile, then each tile read again from L2.
    - "scalar" (K % 8 != 0): one warp a row, scalar loads.
    """
    if k % 8:
        return HGeometry("scalar", 0, 32, H_SCALAR_ROWS, _cdiv(m, H_SCALAR_ROWS))
    n = k // 8

    def tpr_of(c):
        return _cdiv(_cdiv(n, c), 32) * 32

    if m >= 4 * sms:
        chunks = max((c for c in (1, 2, 4, 8) if tpr_of(c) * c * 8 <= 9 * n), default=8)
    else:
        chunks = next((c for c in (1, 2, 4, 8) if _cdiv(n, c) <= H_MAX_THREADS), 8)
    tpr = min(tpr_of(chunks), H_MAX_THREADS)
    rows = max(1, H_BLOCK_THREADS // tpr)
    return HGeometry("registers" if k <= H_REG_VALUES else "sweep", chunks, tpr, rows, _cdiv(m, rows))


def _launch_h(x2: torch.Tensor, geo: HGeometry):
    """H on contiguous bf16 rows x2 (M, K) at launch `geo`, counted →
    int8 (M, K), f32 (M, 1)."""
    global quantize_launches
    m, k = x2.shape
    lib = _build.load("w8a8_matmul", _SIGNATURES)
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = lib.fgt_quantize_rows(x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k, geo.chunks, geo.tpr,
                                    geo.rows, geo.blocks, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("fgt_quantize_rows", err)
    quantize_launches += 1
    return xq, sx


def _quantize_rows_cuda(x):
    *lead, k = x.shape
    x2 = _rows(x)
    _check_2d(x2, "row quantizer")
    xq, sx = _launch_h(x2, quantize_geometry(x2.shape[0], k, _build.sm_count(x2.device.index)))
    return xq.reshape(*lead, k), sx.reshape(*lead, 1)


def w8a8_matmul(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor) -> torch.Tensor:
    """x (…, K) @ int8 kernel (K, N) with per-channel (N,) scales → (…, N)
    in x's dtype; the activations are quantized inside (kernel G)."""
    if x.device.type == "cuda":
        return _w8a8_matmul_cuda(x, kernel_q, kernel_scale)
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, kernel_q, kernel_scale)
    raise ValueError(f"no W8A8 matmul for device {x.device}")


def quantize_rows(x: torch.Tensor):
    """x (…, K) → int8 (…, K) and f32 (…, 1) per-row scales (kernel H)."""
    if x.device.type == "cuda":
        return _quantize_rows_cuda(x)
    if x.device.type == "cpu":
        return quantize_rows_reference(x)
    raise ValueError(f"no row quantizer for device {x.device}")
