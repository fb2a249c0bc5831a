"""int4 unpack-in-matmul: CUDA kernel and plain version.

The kernel (csrc/int4_matmul.cu, sm_90a) replaces the TPU kernel `_kernel`
of flux_generator_tpu/ops/pallas/int4_matmul.py. `int4_matmul` dispatches on
the input's device only: CPU tensors go to `int4_matmul_reference`, CUDA
tensors to the kernel, which raises for shapes, dtypes or layouts it does not
take. There is no fallback from one to the other. The kernel takes what the
TPU wrapper takes: any M, any N (like the TPU wrapper, this one pads a ragged
N with 0x88 bytes, which dequantize to 0; the kernel stores no column past N)
and bf16 or f32 activations. Which shapes reach it is `supported`'s decision,
the TPU package's own branch in `dense` (ops/linear.py).

The bf16 route (a wgmma kernel fed by TMA; the source's head note) cuts the
output into tiles of 128 or 256 rows × 128 columns and each tile's packed rows
into `splits` parts, one a block of a thread-block cluster; `plan` picks the
split and the persistent grid.

Weights are the repo's packed-int4 format (ops/quant.pack_int4): (K/2, N)
uint8, split layout, with f32 scales per output channel (N,) or per input
group (K/gs, N), the first g/2 groups belonging to the low half.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/int4_matmul.cu"
REPLACES = "flux_generator_tpu/ops/pallas/int4_matmul.py:148"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, scale, out, M, N, pitch, K, group_size, x_f32, nw, splits, grid, stream
    "fgt_int4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # nw, splits, clusters
    "fgt_int4_matmul_clusters": [_I, _I, _P],
    # nw, mode, registers, spill bytes, shared memory bytes, blocks an SM, stages
    "fgt_int4_matmul_info": [_I, _I, _P, _P, _P, _P, _P],
}
X_DTYPES = (torch.bfloat16, torch.float32)
_BK_CANDIDATES = (512, 256, 128)  # the TPU kernel's packed rows per step

BLOCK_ROWS = 64  # packed rows of a K half a ring stage holds
TILE_N = 128  # weight columns a tile
ROW_TILES = (128, 256)  # x rows a tile: the wgmma's N side
MAX_SPLITS = {128: 8, 256: 4}  # the split's exchange reuses the copy ring's shared memory
# The exchange of a tile's f32 sums between its splits (waiting for the
# cluster, the sums staged and sent to their owners, each slice summed), in
# packed blocks of a split's K loop, times (splits − 1)/splits: fitted to every
# split's time at the T5-XXL shapes on an H100 (chip_smoke.py's B phase times
# them in turns), where a block took about 1.4 µs and the exchange about 14.
FOLD_BLOCKS = 10
SCALE_MODES = {"per_channel": 0, "group_stage": 1, "group_row": 2}  # group_row: 128-row tiles only


def _pick_bk(kp: int, group_size: int) -> int:
    """The TPU kernel's K block: the largest candidate that tiles the packed
    rows and covers whole scale groups; 0 if none fits."""
    for bk in _BK_CANDIDATES:
        if kp % bk == 0 and (group_size == 0 or bk % group_size == 0):
            return bk
    return 0


def supported(k: int, kernel_scale: torch.Tensor) -> bool:
    """Whether the TPU package runs its int4 kernel for this packed layout
    (flux_generator_tpu/ops/pallas/int4_matmul.py `supported`): K/2 tiles a
    block candidate and, grouped, the block covers whole groups. Elsewhere
    its `dense` takes the two-halves formulation, and so does the port's."""
    if k % 2:
        return False
    if kernel_scale.dim() == 2:
        g = kernel_scale.shape[0]
        if g % 2 or k % g:
            return False
        return _pick_bk(k // 2, k // g) > 0
    return _pick_bk(k // 2, 0) > 0


def _halves(kernel_q4: torch.Tensor):
    """Packed (K/2, N) uint8 → (low-half rows, high-half rows) as f32 ints."""
    p = kernel_q4.to(torch.int32)
    return ((p & 15) - 8).float(), ((p >> 4) - 8).float()


def int4_matmul_reference(x: torch.Tensor, kernel_q4: torch.Tensor,
                          kernel_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: x (…, K) → (…, N) in
    x's dtype (bf16 or f32), any M and N, accumulated in f32. Grouped weights
    are dequantized in f32 and rounded to x's dtype before the product;
    per-channel scales are applied to the f32 result, as the kernel folds
    them after its K loop."""
    *lead, k = x.shape
    kp, n = kernel_q4.shape
    lo, hi = _halves(kernel_q4)
    if kernel_scale.ndim == 2:
        g = kernel_scale.shape[0]
        gs = k // g
        s = kernel_scale.float().repeat_interleave(gs, dim=0)
        lo = (lo * s[:kp]).to(x.dtype).float()
        hi = (hi * s[kp:]).to(x.dtype).float()
    x2 = x.reshape(-1, k).float()
    y = x2[:, :kp] @ lo + x2[:, kp:] @ hi
    if kernel_scale.ndim == 1:
        y = y * kernel_scale.float()
    return y.to(x.dtype).reshape(*lead, n)


def _check_cuda_args(x2, kernel_q4, kernel_scale):
    m, k = x2.shape
    if x2.dtype not in X_DTYPES:
        raise ValueError(f"int4 kernel takes bf16 or f32 activations, got {x2.dtype}")
    if kernel_q4.dtype != torch.uint8 or kernel_q4.dim() != 2 or kernel_q4.shape[0] * 2 != k:
        raise ValueError(f"int4 kernel takes packed (K/2, N) uint8 weights for K={k}, got "
                         f"{kernel_q4.dtype} {tuple(kernel_q4.shape)}")
    n = kernel_q4.shape[1]
    if k % 64:
        raise ValueError(f"int4 kernel needs K % 64 == 0, got K={k}")
    if kernel_scale.dtype != torch.float32:
        raise ValueError(f"int4 kernel takes f32 scales, got {kernel_scale.dtype}")
    if kernel_scale.dim() == 1:
        if kernel_scale.shape[0] != n:
            raise ValueError(f"per-channel scales must be ({n},), got {tuple(kernel_scale.shape)}")
    elif kernel_scale.dim() == 2:
        g = kernel_scale.shape[0]
        if kernel_scale.shape[1] != n or k % g or g % 2 or (k // 2) % (k // g):
            raise ValueError(f"grouped scales {tuple(kernel_scale.shape)} do not tile K={k} "
                             "into whole groups per half")
    else:
        raise ValueError(f"scales must be (N,) or (groups, N), got {tuple(kernel_scale.shape)}")
    if not (x2.is_contiguous() and kernel_q4.is_contiguous() and kernel_scale.is_contiguous()):
        raise ValueError("int4 kernel takes contiguous operands")
    if x2.data_ptr() % 16 or kernel_q4.data_ptr() % 16:
        raise ValueError("int4 kernel takes 16-byte aligned activations and weights")
    if kernel_q4.device != x2.device or kernel_scale.device != x2.device:
        raise ValueError("operands must lie on one device")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int, capacity, row_scales: bool = False) -> tuple:
    """(x rows a tile, K splits, persistent blocks) of the bf16 route, where
    `capacity(nw, splits)` is how many blocks the card runs at once in
    clusters of `splits` (a multiple of it). A tile holds 128 rows of x where
    M ≤ 128, else 256, so at M ≤ 256 every packed byte is unpacked once; group
    sizes that are no multiple of 64 (`row_scales`) take 128 always. The
    split is the one whose busiest block has the least to do: ⌈tiles /
    clusters⌉ tiles of ⌈blocks of 64 packed rows / splits⌉ and the exchange,
    the fewer splits on a tie; the grid is no larger than the tiles need."""
    nw = ROW_TILES[0] if m <= ROW_TILES[0] or row_scales else ROW_TILES[1]
    tiles = _cdiv(m, nw) * _cdiv(n, TILE_N)
    blocks = _cdiv(k // 2, BLOCK_ROWS)
    best = None
    for splits in range(1, min(MAX_SPLITS[nw], blocks) + 1):
        clusters = min(tiles, capacity(nw, splits) // splits)
        if clusters < 1:
            continue
        cost = _cdiv(tiles, clusters) * (_cdiv(blocks, splits) + FOLD_BLOCKS * (splits - 1) / splits)
        if best is None or cost < best[0] - 1e-9:
            best = (cost, splits, clusters * splits)
    return nw, best[1], best[2]


_CAPACITY: dict = {}


def _capacity(index: int):
    """capacity(nw, splits) of CUDA device `index`: the blocks its clusters of
    `splits` fill at once (asked once a tile height and split)."""
    def capacity(nw: int, splits: int) -> int:
        key = (index, nw, splits)
        if key not in _CAPACITY:
            lib = _build.load("int4_matmul", _SIGNATURES)
            clusters = ctypes.c_int()
            with torch.cuda.device(index):
                _build.check("fgt_int4_matmul_clusters", lib.fgt_int4_matmul_clusters(nw, splits, ctypes.byref(clusters)))
            _CAPACITY[key] = clusters.value * splits
        return _CAPACITY[key]
    return capacity


def _pad_n(kernel_q4: torch.Tensor):
    """(weights, row pitch) for the bf16 route: TMA copies rows of a multiple
    of 16 bytes, so a ragged N is padded with 0x88 bytes (q = 0), as the TPU
    wrapper pads N to its blocks; the kernel stores no column past N."""
    kp, n = kernel_q4.shape
    if n % 16 == 0:
        return kernel_q4, n
    pitch = _cdiv(n, 16) * 16
    w = kernel_q4.new_full((kp, pitch), 0x88)
    w[:, :n] = kernel_q4
    return w, pitch


def kernel_info(nw: int = 256, mode: str = "group_stage") -> dict:
    """The bf16 route's kernel for tiles of `nw` x rows and scale mode `mode`
    (SCALE_MODES): registers a thread at launch, local memory (spill) bytes a
    thread, shared memory bytes a block, blocks an SM, ring stages."""
    lib = _build.load("int4_matmul", _SIGNATURES)
    vals = [ctypes.c_int() for _ in range(5)]
    _build.check("fgt_int4_matmul_info",
                 lib.fgt_int4_matmul_info(nw, SCALE_MODES[mode], *(ctypes.byref(v) for v in vals)))
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm", "stages"), (v.value for v in vals)))


def _int4_matmul_cuda(x, kernel_q4, kernel_scale):
    global launches
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    _check_cuda_args(x2, kernel_q4, kernel_scale)
    m, n = x2.shape[0], kernel_q4.shape[1]
    group_size = k // kernel_scale.shape[0] if kernel_scale.dim() == 2 else 0
    x_f32 = x.dtype == torch.float32
    w, s, pitch = kernel_q4, kernel_scale, n
    nw, splits, grid = 0, 1, 0
    rows = m
    if not x_f32:
        # the bf16 route stores whole tiles: rows to a multiple of the tile's,
        # columns to the weights' padded pitch; what lies past (M, N) is dropped
        w, pitch = _pad_n(kernel_q4)
        if s.dim() == 2 and (pitch != n or s.data_ptr() % 16):  # TMA reads group rows of `pitch` values
            s = s.new_zeros((s.shape[0], pitch))
            s[:, :n] = kernel_scale
        nw, splits, grid = plan(m, n, k, _capacity(x.device.index), group_size % BLOCK_ROWS != 0)
        rows = _cdiv(m, nw) * nw
    lib = _build.load("int4_matmul", _SIGNATURES)
    out = torch.empty((rows, pitch), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fgt_int4_matmul(
            x2.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
            m, n, pitch, k, group_size, int(x_f32), nw, splits, grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("fgt_int4_matmul", err)
    launches += 1
    out = out[:m] if pitch == n else out[:m, :n].contiguous()
    return out.reshape(*lead, n)


def int4_matmul(x: torch.Tensor, kernel_q4: torch.Tensor,
                kernel_scale: torch.Tensor) -> torch.Tensor:
    """x (…, K) @ packed int4 kernel (K/2, N) → (…, N) in x's dtype."""
    if x.device.type == "cuda":
        return _int4_matmul_cuda(x, kernel_q4, kernel_scale)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, kernel_q4, kernel_scale)
    raise ValueError(f"no int4 matmul for device {x.device}")
