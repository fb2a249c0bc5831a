"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` into `csrc/build/<name>-<hash>.so`, where the hash covers the source
files and the flags, so an edited source rebuilds and an unchanged one loads
from the cache. Nothing here runs at import time: this module is imported on
machines with no `nvcc` and no GPU, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_LOCK = threading.Lock()  # guards _LOCKS; each kernel builds under its own lock
_LOCKS: dict = {}
_LIBS: dict = {}
# name → (seconds spent in nvcc or 0.0 for a cache hit, ptxas report)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found (PATH, CUDA_HOME, {path}); the CUDA kernels "
                           "are built on the machine that runs them")
    return str(path)


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for src in sorted([CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(name: str) -> Path:
    out = BUILD_DIR / f"{name}-{_digest(name)}.so"
    log = out.with_suffix(".log")
    if out.exists():
        BUILD_INFO[name] = (0.0, log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    BUILD_INFO[name] = (seconds, proc.stdout + proc.stderr)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Compile (or reuse) `csrc/<name>.cu` and return the loaded library with
    `argtypes`/`restype` set from `signatures` ({symbol: [argtypes]}; every
    entry returns an int cudaError_t). Different kernels may build at the
    same time from several threads."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for sym, argtypes in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`, asked once (the
    launch geometries depend on it; G and H run 920 times a request)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(name: str, err: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
