"""CLIP byte-pair-encoding tokenizer (the port's own copy of
flux_generator_tpu/tokenizers/clip_bpe.py).

The per-word merge loop runs in the native engine (tokenizers/native.py,
built from csrc/clip_bpe.cpp at first use) by default, or in Python with
engine="python"; a word whose ids overflow the native buffer takes the
Python loop. Lowercase + whitespace collapse, CLIP word-split regex, per-word BPE with
`</w>` end marker, 77-token cap with forced EOS, EOS-padded batch encode,
and the byte→unicode mapping so non-ASCII prompts round-trip. Needs the
`regex` module, imported when a tokenizer is built.
"""

from __future__ import annotations

import functools
import gzip
import json
from pathlib import Path

from .native import NativeBpe, check_engine

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
_WORD_PAT = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"""
             r"""[^\s\p{L}\p{N}]+""")


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2/CLIP reversible byte→printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class CLIPTokenizer:
    def __init__(self, vocab: dict, merges: list, max_length: int = 77, engine: str = "native"):
        """vocab: token→id; merges: list of (a, b) pairs in rank order;
        engine "native" or "python" (tokenizers/native.py). Raises
        ImportError where the `regex` module is missing."""
        import regex

        check_engine(engine)
        self._regex = regex
        self._word_pat = regex.compile(_WORD_PAT, regex.IGNORECASE)
        self.max_length = max_length
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self._cache = {BOS: [BOS], EOS: [EOS]}
        self.engine = engine
        self._native = NativeBpe(vocab, list(map(tuple, merges)), vocab.get(EOS, 0)) \
            if engine == "native" else None

    # -------------------------------------------------- constructors

    @classmethod
    def from_files(cls, vocab_file, merges_file, max_length: int = 77, engine: str = "native"):
        """HF-format vocab.json + merges.txt."""
        with open(vocab_file) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                merges.append(tuple(line.split()))
        return cls(vocab, merges, max_length, engine)

    @classmethod
    def from_openai_bpe(cls, bpe_path, max_length: int = 77, engine: str = "native"):
        """OpenAI bpe_simple_vocab_16e6.txt(.gz): merges imply the vocab."""
        opener = gzip.open if str(bpe_path).endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        chars = list(bytes_to_unicode().values())
        tokens = chars + [c + "</w>" for c in chars]
        tokens += ["".join(m) for m in merges]
        tokens += [BOS, EOS]
        vocab = {t: i for i, t in enumerate(tokens)}
        return cls(vocab, merges, max_length, engine)

    @classmethod
    def from_pretrained_dir(cls, path, max_length: int = 77, engine: str = "native"):
        path = Path(path)
        if (path / "vocab.json").exists():
            return cls.from_files(path / "vocab.json", path / "merges.txt", max_length, engine)
        for name in ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt"):
            if (path / name).exists():
                return cls.from_openai_bpe(path / name, max_length, engine)
        raise FileNotFoundError(f"no CLIP tokenizer files in {path}")

    # -------------------------------------------------- properties

    @property
    def bos_token(self) -> int:
        return self.vocab[BOS]

    @property
    def eos_token(self) -> int:
        return self.vocab[EOS]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -------------------------------------------------- BPE

    def _bpe(self, word: str) -> list:
        if word in self._cache:
            return self._cache[word]

        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = set(zip(parts, parts[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        self._cache[word] = parts
        return parts

    # -------------------------------------------------- public API

    def tokenize(self, text, prepend_bos: bool = True, append_eos: bool = True):
        if isinstance(text, list):
            return [self.tokenize(t, prepend_bos, append_eos) for t in text]

        clean = self._regex.sub(r"\s+", " ", text.lower()).strip()
        words = self._word_pat.findall(clean)

        unk = self.vocab.get(EOS)
        ids = []
        for w in words:
            if w not in (BOS, EOS):
                w = "".join(self.byte_encoder[b] for b in w.encode("utf-8"))
                if self._native is not None:
                    native_ids = self._native.encode_word(w)
                    if native_ids is not None:  # None: overflow, the Python loop takes the word
                        ids.extend(native_ids)
                        continue
            for piece in self._bpe(w):
                ids.append(self.vocab.get(piece, unk))

        if prepend_bos:
            ids = [self.bos_token] + ids
        if append_eos:
            ids.append(self.eos_token)
        if len(ids) > self.max_length:
            ids = ids[: self.max_length]
            if append_eos:
                ids[-1] = self.eos_token
        return ids

    def encode(self, text):
        """Batch encode, EOS-padded to the longest row → list of lists."""
        if not isinstance(text, list):
            return self.encode([text])
        rows = self.tokenize(text)
        length = max(len(r) for r in rows)
        return [r + [self.eos_token] * (length - len(r)) for r in rows]
