"""The chain-bisect probe: CUDA kernel (#12) and plain version.

The kernel (csrc/chain_bisect.cu, sm_90a) replaces the TPU kernel that
`make_kernel` builds in scripts/prof_chain_bisect.py (pallas_call at :269):
the decode-chain probe's weight stream (#11, on kernel D's machinery) with
the structural pieces of the fused decode step added one at a time, each
built where and as D builds it (csrc/decode_probe.cuh), so that a rung's
increment is D's cost of that piece. One layer, on x (M, H):
  LN → (× ln[l, 0] + ln[l, 1] with `ln`) → q = c0, k = c1, v = c2;
  x += c3·q + 0·(k + v)[:, :1]; LN → x += c5·(c4·LN (+ 0·Σ cross rows));
  LN → up c6..c9 → tanh GELU per chunk → x += Σ c10..c13.
Dots round their inputs to bf16 and dequantize w.bf16 · s.bf16 to bf16, with
f32 accumulation; the residual stays f32; y is bf16.

The extras (EXTRAS, the script's order) and their operands:
  smem   `offset`, an int, never read
  ln     `ln` (L, 8, H) bf16
  cross  `ck`, `cv` (L, 2, S, H) bf16: + 0·Σ_b ck[l, b, 0] + 0·Σ_b cv[l, b, 0]
         into c4's output
  hbm    `kc`, `vc` (L, 2, W, H) bf16, not read without dma
  bufs   the staging buffers (no operand)
  outs   returns (y, kn, vn), kn/vn (L, 2, H) bf16: rows 0..1 of c1's and
         c2's products
  dma    reads every layer's K and V window (needs hbm and bufs; the kernel
         with D's warp loads) and adds 0·(the row the script's chunks of
         `chunk` rows leave in slot 0, K + V) into the o input
`chain_bisect` dispatches on the tensors' device: CPU tensors go to
`chain_bisect_plain`, CUDA tensors to the kernel; it raises for what neither
takes, and the kernel also for w, s, ln, kc or vc not 16-byte aligned (TMA
and 16-byte loads).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_step import CPL, MAX_BATCH, MAX_HIDDEN, _bf, _ln_f32

# Launches of the CUDA kernel since the last reset (the plain version on CPU
# tensors does not count).
launches = 0

SOURCE = "flux_generator_tpu_torch/csrc/chain_bisect.cu"
REPLACES = "scripts/prof_chain_bisect.py:269"

EXTRAS = ("smem", "ln", "cross", "hbm", "bufs", "outs", "dma")
# the script's ladder (LADDER, l.329) and the eight cumulative rungs of EXTRAS
LADDER = ("", "smem", "smem,ln", "smem,ln,cross")
RUNGS = tuple(",".join(EXTRAS[:i]) for i in range(len(EXTRAS) + 1))
B = 2  # rows of the cross K/V, the caches and kn/vn (the script's B)
# the keyword operands and the extra each goes with
OPERAND_EXTRA = {"offset": "smem", "ln": "ln", "ck": "cross", "cv": "cross", "kc": "hbm", "vc": "hbm"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # w, s, ln, x, ck, cv, kc, vc, y, kn, vn, scratch, L, M, H, S, W, touched row, offset, extras, stream
    "fgt_chain_bisect": [_P] * 12 + [_I] * 8 + [_P],
    "fgt_chain_bisect_plan": [_I, _I, _I, _P],  # M, H, extras, int[5] out
}


def parse_extras(extras) -> frozenset:
    """The set of extras from a comma list ("smem,ln") or an iterable of
    names; raises on an unknown name and on dma without hbm and bufs, as the
    script does."""
    names = extras.split(",") if isinstance(extras, str) else list(extras)
    out = frozenset(n for n in names if n)
    unknown = out - set(EXTRAS)
    if unknown:
        raise ValueError(f"unknown extras {sorted(unknown)}; the script's are {EXTRAS}")
    if "dma" in out and not {"hbm", "bufs"} <= out:
        raise ValueError("extras dma requires hbm,bufs")
    return out


def extras_mask(extras) -> int:
    """The kernel's bit mask: bit i for EXTRAS[i]."""
    ex = parse_extras(extras)
    return sum(1 << i for i, name in enumerate(EXTRAS) if name in ex)


def gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """The script's GELU (l.192), in g's dtype."""
    return 0.5 * g * (1.0 + torch.tanh(0.7978845608 * (g + 0.044715 * g ** 3)))


def touched_row(window: int, chunk: int) -> int:
    """The cache row the script's dma touches (row 0 of slot 0 of b 0): the
    first row of the last chunk that went into slot 0."""
    n_chunks = -(-window // chunk)
    return (n_chunks - 1) // 2 * 2 * chunk


def chain_bisect_plain(w, s, x, extras, *, offset=None, ln=None, ck=None, cv=None, kc=None, vc=None,
                       chunk=512):
    """Plain PyTorch version: the script's kernel, layer by layer, with its
    0· terms, so a NaN in a read operand travels as it does there."""
    ex = parse_extras(extras)
    n_layers = w.shape[0] // CPL
    h = x.shape[-1]
    ones, zeros = torch.ones(h, device=x.device), torch.zeros(h, device=x.device)
    xs = x.float()
    kn, vn = [], []
    for li in range(n_layers):
        def mm(a, c, li=li):
            k = (w[li * CPL + c].to(torch.bfloat16) * s[li * CPL + c].to(torch.bfloat16)).float()
            return _bf(a) @ k

        lns = _ln_f32(xs, ones, zeros)
        if "ln" in ex:
            lns = lns * ln[li, 0].float() + ln[li, 1].float()
        ys = mm(lns, 0)
        t = mm(lns, 1)
        ts = t
        kn.append(t[:B].to(torch.bfloat16))
        t = mm(lns, 2)
        ts = ts + t
        vn.append(t[:B].to(torch.bfloat16))
        if "dma" in ex:
            row = touched_row(kc.shape[2], chunk)
            ys = ys + 0.0 * kc[li, 0, row].float() + 0.0 * vc[li, 0, row].float()
        xs = xs + mm(ys, 3) + 0.0 * ts[:, :1]
        lns = _ln_f32(xs, ones, zeros)
        base = mm(lns, 4)
        if "cross" in ex:
            base = base + 0.0 * ck[li, :, 0].float().sum(0) + 0.0 * cv[li, :, 0].float().sum(0)
        xs = xs + mm(base, 5)
        lns = _ln_f32(xs, ones, zeros)
        hs = [mm(lns, 6 + j) for j in range(4)]
        acc = torch.zeros_like(xs)
        for j in range(4):
            acc = acc + mm(gelu_tanh(hs[j]), 10 + j)
        xs = xs + acc
    y = xs.to(x.dtype)
    if "outs" in ex:
        return y, torch.stack(kn), torch.stack(vn)
    return y


def _check_args(w, s, x, ex, operands, chunk):
    """Types and shapes the kernel takes, and the operands the extras need
    (and no others); the plain version is held to the same."""
    if w.dtype != torch.int8 or s.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"chain-bisect takes int8 w, bf16 s and x, got {w.dtype}, {s.dtype}, {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, H), got {tuple(x.shape)}")
    m, h = x.shape
    if w.dim() != 3 or w.shape[1:] != (h, h) or w.shape[0] % CPL or w.shape[0] == 0:
        raise ValueError(f"w must be (L·{CPL}, H, H) with H = {h}, got {tuple(w.shape)}")
    if s.shape != (w.shape[0], 1, h):
        raise ValueError(f"s must be ({w.shape[0]}, 1, {h}), got {tuple(s.shape)}")
    if not 1 <= m <= MAX_BATCH or h % 256 or h > MAX_HIDDEN:
        raise ValueError(f"chain-bisect takes 1..{MAX_BATCH} rows and H a multiple of 256 up to {MAX_HIDDEN}, "
                         f"got ({m}, {h})")
    if "outs" in ex and m < B:
        raise ValueError(f"extras outs writes rows 0..{B - 1}, x has {m}")
    n_layers = w.shape[0] // CPL
    for key, extra in OPERAND_EXTRA.items():
        given = operands[key] is not None
        if given != (extra in ex):
            raise ValueError(f"operand {key} goes with extras {extra}: " +
                             ("missing" if not given else f"given without {extra}"))
    if "smem" in ex and not isinstance(operands["offset"], int):
        raise ValueError(f"offset must be an int, got {type(operands['offset'])}")

    def rows(t):  # S of the cross K/V, W of the caches
        return t.shape[2] if t.dim() == 4 else -1

    shapes = {"ln": (n_layers, 8, h)}
    if "cross" in ex:
        shapes.update(ck=(n_layers, B, rows(operands["ck"]), h), cv=(n_layers, B, rows(operands["ck"]), h))
    if "hbm" in ex:
        shapes.update(kc=(n_layers, B, rows(operands["kc"]), h), vc=(n_layers, B, rows(operands["kc"]), h))
    for key, shape in shapes.items():
        t = operands[key]
        if t is not None and (t.dtype != torch.bfloat16 or tuple(t.shape) != shape or min(shape) < 1):
            raise ValueError(f"{key} must be bf16 {shape}, got {t.dtype} {tuple(t.shape)}")
    if "dma" in ex and (not isinstance(chunk, int) or chunk < 1):
        raise ValueError(f"chunk must be a positive int, got {chunk}")


def plan(m: int, h: int, extras) -> dict:
    """The kernel's launch plan on the current card: grid, resident blocks
    an SM, dynamic shared memory a block, f32 scratch floats, grid syncs a
    layer."""
    lib = _build.load("chain_bisect", _SIGNATURES)
    out = (ctypes.c_int * 5)()
    _build.check("fgt_chain_bisect_plan", lib.fgt_chain_bisect_plan(m, h, extras_mask(extras), out))
    return dict(grid=out[0], blocks_per_sm=out[1], smem_bytes=out[2], scratch_floats=out[3],
                syncs_per_layer=out[4])


def _check_kernel_operands(w, s, x, operands):
    """What the kernel takes beyond the contract: contiguous tensors on one
    device; w (its TMA map), s, ln and the caches (16-byte loads) 16-byte
    aligned."""
    tensors = [w, s, x] + [t for k, t in operands.items() if k != "offset" and t is not None]
    if any(not t.is_contiguous() for t in tensors) or any(t.device != x.device for t in tensors):
        raise ValueError("chain-bisect kernel takes contiguous tensors on one device")
    for key, t in (("w", w), ("s", s), ("ln", operands["ln"]), ("kc", operands["kc"]), ("vc", operands["vc"])):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"chain-bisect kernel reads {key} through TMA or in 16-byte pieces: it must be "
                             "16-byte aligned")


def _chain_bisect_cuda(w, s, x, ex, operands, chunk):
    global launches
    _check_kernel_operands(w, s, x, operands)
    m, h = x.shape
    n_layers = w.shape[0] // CPL
    mask = extras_mask(ex)
    lib = _build.load("chain_bisect", _SIGNATURES)
    y = torch.empty_like(x)
    kn = vn = None
    if "outs" in ex:
        kn = torch.empty((n_layers, B, h), dtype=torch.bfloat16, device=x.device)
        vn = torch.empty_like(kn)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        p = plan(m, h, ex)
        scratch = torch.empty(p["scratch_floats"], dtype=torch.float32, device=x.device)
        ck, kc = operands["ck"], operands["kc"]
        err = lib.fgt_chain_bisect(ptr(w), ptr(s), ptr(operands["ln"]), ptr(x), ptr(ck), ptr(operands["cv"]),
                                   ptr(kc), ptr(operands["vc"]), ptr(y), ptr(kn), ptr(vn), ptr(scratch),
                                   n_layers, m, h, 0 if ck is None else ck.shape[2],
                                   0 if kc is None else kc.shape[2],
                                   touched_row(kc.shape[2], chunk) if "dma" in ex else 0,
                                   operands["offset"] or 0, mask,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fgt_chain_bisect", err)
    launches += 1
    return (y, kn, vn) if "outs" in ex else y


def chain_bisect(w, s, x, extras, *, offset=None, ln=None, ck=None, cv=None, kc=None, vc=None, chunk=512):
    """One step through all L layers with `extras` → y (M, H) bf16, or (y,
    kn, vn) with outs."""
    ex = parse_extras(extras)
    operands = dict(offset=offset, ln=ln, ck=ck, cv=cv, kc=kc, vc=vc)
    _check_args(w, s, x, ex, operands, chunk)
    if x.device.type == "cuda":
        return _chain_bisect_cuda(w, s, x, ex, operands, chunk)
    if x.device.type == "cpu":
        return chain_bisect_plain(w, s, x, ex, chunk=chunk, **operands)
    raise ValueError(f"no chain bisect for device {x.device}")
