"""The tokenizers' native engines (the port's build of the JAX package's
`libfgt_tokenizer.so`): the CLIP BPE merge loop (csrc/clip_bpe.cpp) and the
SentencePiece unigram Viterbi (csrc/spm_unigram.cpp), plain C interfaces
loaded with ctypes.

The library is compiled at first use with `g++ -O2 -shared -fPIC` into
csrc/build/libfgt_tokenizer-<hash>.so, the hash covering the sources and
the flags, so an edited source rebuilds and an unchanged one loads from the
cache. Several processes may build at once (test workers, server ranks): one
builds under a file lock and renames its output into place, the others then
load it. A failed build raises; nothing falls back to the Python engines
unless the caller chose them.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("clip_bpe.cpp", "spm_unigram.cpp")
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
ENGINES = ("native", "python")
BPE_MAX_IDS = 512  # ids a word's BPE may give; past it the Python merge loop takes the word
SPM_MAX_IDS = 4096  # pieces a text may segment into; past it the Python Viterbi takes the text

_P, _I32, _S = ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p
_SIGNATURES = {
    "fgt_bpe_create": ([], _P),
    "fgt_bpe_destroy": ([_P], None),
    "fgt_bpe_add_token": ([_P, _S, _I32], None),
    "fgt_bpe_set_unk": ([_P, _I32], None),
    "fgt_bpe_add_merge": ([_P, _S, _S, _I32], None),
    "fgt_bpe_encode_word": ([_P, _S, ctypes.POINTER(_I32), _I32], _I32),
    "fgt_spm_create": ([], _P),
    "fgt_spm_destroy": ([_P], None),
    "fgt_spm_add_piece": ([_P, _S, ctypes.c_double, _I32], None),
    "fgt_spm_add_byte": ([_P, _I32, _I32], None),
    "fgt_spm_set_unk": ([_P, _I32], None),
    "fgt_spm_encode": ([_P, _S, ctypes.POINTER(_I32), _I32], _I32),
}


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """The built library in `build_dir`, compiling it first where it is
    missing."""
    build_dir = Path(build_dir)
    out = build_dir / f"libfgt_tokenizer-{_digest()}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "libfgt_tokenizer.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if out.exists():  # built by another process while this one waited
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native tokenizer engines are built at first use "
                               "(pass engine='python' for the pure-Python engines)")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [gxx, *FLAGS, *(str(CSRC / name) for name in SOURCES), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native tokenizers failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The library, loaded once a process, with every entry point's types."""
    lib = ctypes.CDLL(str(library_path()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


class NativeBpe:
    """The CLIP BPE merge engine over one vocab and merge list."""

    def __init__(self, vocab: dict, merges: list, unk_id: int):
        self._lib = load_library()
        self._h = self._lib.fgt_bpe_create()
        for tok, i in vocab.items():
            self._lib.fgt_bpe_add_token(self._h, tok.encode(), i)
        self._lib.fgt_bpe_set_unk(self._h, unk_id)
        for rank, (a, b) in enumerate(merges):
            self._lib.fgt_bpe_add_merge(self._h, a.encode(), b.encode(), rank)
        self._buf = (_I32 * BPE_MAX_IDS)()

    def encode_word(self, word: str):
        """A byte-encoded word's ids, or None where they overflow the buffer
        (the caller then runs the Python merge loop on the word)."""
        n = self._lib.fgt_bpe_encode_word(self._h, word.encode(), self._buf, BPE_MAX_IDS)
        return None if n < 0 else list(self._buf[:n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fgt_bpe_destroy(self._h)


class NativeUnigram:
    """The SentencePiece unigram Viterbi engine over one piece table."""

    def __init__(self, scores: dict, ids: dict, byte_pieces: dict, unk_id: int):
        self._lib = load_library()
        self._h = self._lib.fgt_spm_create()
        for piece, score in scores.items():
            self._lib.fgt_spm_add_piece(self._h, piece.encode(), score, ids[piece])
        for b, i in byte_pieces.items():
            self._lib.fgt_spm_add_byte(self._h, b, i)
        self._lib.fgt_spm_set_unk(self._h, unk_id)
        self._buf = (_I32 * SPM_MAX_IDS)()

    def segment(self, text: str) -> list:
        """The normalized text's piece ids; ValueError past SPM_MAX_IDS."""
        n = self._lib.fgt_spm_encode(self._h, text.encode(), self._buf, SPM_MAX_IDS)
        if n < 0:
            raise ValueError(f"segmentation overflow (>{SPM_MAX_IDS} pieces)")
        return list(self._buf[:n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fgt_spm_destroy(self._h)
