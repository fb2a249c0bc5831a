"""int4 unpack-in-matmul: CUDA kernel and plain version.

The kernel (csrc/int4_matmul.cu, sm_90a) replaces the TPU kernel `_kernel`
of flux_generator_tpu/ops/pallas/int4_matmul.py. `int4_matmul` dispatches on
the input's device only: CPU tensors go to `int4_matmul_reference`, CUDA
tensors to the kernel, which raises for shapes, dtypes or layouts it does not
take. There is no fallback from one to the other. The kernel takes what the
TPU wrapper takes: any M, any N (the TPU wrapper pads N with 0x88 bytes, which
dequantize to 0; the kernel masks them) and bf16 or f32 activations. Which
shapes reach it is `supported`'s decision, the TPU package's own branch in
`dense` (ops/linear.py).

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
_SIGNATURES = {
    "fgt_int4_matmul": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P],
}
X_DTYPES = (torch.bfloat16, torch.float32)
_BK_CANDIDATES = (512, 256, 128)  # the TPU kernel's packed rows per step


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


def _int4_matmul_cuda(x, kernel_q4, kernel_scale):
    global launches
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    _check_cuda_args(x2, kernel_q4, kernel_scale)
    m, n = x2.shape[0], kernel_q4.shape[1]
    group_size = k // kernel_scale.shape[0] if kernel_scale.dim() == 2 else 0
    lib = _build.load("int4_matmul", _SIGNATURES)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fgt_int4_matmul(
            x2.data_ptr(), kernel_q4.data_ptr(), kernel_scale.data_ptr(), out.data_ptr(),
            m, n, k, group_size, int(x.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check("fgt_int4_matmul", err)
    launches += 1
    return out.reshape(*lead, n)


def int4_matmul(x: torch.Tensor, kernel_q4: torch.Tensor,
                kernel_scale: torch.Tensor) -> torch.Tensor:
    """x (…, K) @ packed int4 kernel (K/2, N) → (…, N) in x's dtype."""
    if x.device.type == "cuda":
        return _int4_matmul_cuda(x, kernel_q4, kernel_scale)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, kernel_q4, kernel_scale)
    raise ValueError(f"no int4 matmul for device {x.device}")
