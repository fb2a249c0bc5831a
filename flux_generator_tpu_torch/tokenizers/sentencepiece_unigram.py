"""SentencePiece unigram tokenizer (the port's own copy of
flux_generator_tpu/tokenizers/sentencepiece_unigram.py).

The Viterbi segmentation runs in the native engine (tokenizers/native.py,
built from csrc/spm_unigram.cpp at first use) by default, or in Python with
engine="python"; a text whose pieces overflow the native buffer takes the
Python Viterbi.

Parses the `.model` protobuf with a minimal wire-format reader and runs
Viterbi unigram segmentation directly. Covers what T5 needs: NFKC-ish
normalization, ▁ word marker with dummy prefix, byte-fallback pieces,
pad-to-max_length encode.
"""

from __future__ import annotations

import struct
import unicodedata

from .native import NativeUnigram, check_engine

SPACE = "▁"  # ▁


# ------------------------------------------------------------ proto parsing


def _read_varint(buf: bytes, i: int):
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val = buf[i : i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_model_proto(data: bytes):
    """Extract (pieces, trainer_spec-ish flags) from a sentencepiece ModelProto.

    ModelProto: field 1 = repeated SentencePiece {piece:1 str, score:2 float,
    type:3 enum}; field 2 = TrainerSpec (unk/bos/eos/pad ids at 40-43,
    model_type at 3); field 3 = NormalizerSpec (add_dummy_prefix at 6)."""
    pieces = []
    trainer = {}
    normalizer = {}
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:
            piece, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:
            def signed(v):
                # protobuf int32 negatives arrive as 64-bit two's complement
                return v - (1 << 64) if v >= 1 << 63 else v

            for f2, w2, v2 in _iter_fields(val):
                if f2 == 40:
                    trainer["unk_id"] = signed(v2)
                elif f2 == 41:
                    trainer["bos_id"] = signed(v2)
                elif f2 == 42:
                    trainer["eos_id"] = signed(v2)
                elif f2 == 43:
                    trainer["pad_id"] = signed(v2)
        elif field == 3 and wire == 2:
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 6:
                    normalizer["add_dummy_prefix"] = bool(v2)
    return pieces, trainer, normalizer


# piece types (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _BYTE, _UNUSED = 1, 2, 3, 4, 6, 5


class SentencePieceUnigramTokenizer:
    def __init__(self, pieces, trainer=None, normalizer=None, max_length: int = 512,
                 engine: str = "native"):
        check_engine(engine)
        self.max_length = max_length
        self.pieces = pieces
        self.scores = {}
        self.ids = {}
        self.id_to_piece = [p for p, _, _ in pieces]
        self.byte_pieces = {}
        self._max_piece_len = 1
        self.unk_id = (trainer or {}).get("unk_id", 2)
        self.bos_id = (trainer or {}).get("bos_id", -1)
        self.eos_id = (trainer or {}).get("eos_id", 1)
        self.pad_id = (trainer or {}).get("pad_id", 0)
        self.add_dummy_prefix = (normalizer or {}).get("add_dummy_prefix", True)
        for i, (piece, score, ptype) in enumerate(pieces):
            if ptype == _BYTE:
                # pieces like <0x41>
                self.byte_pieces[int(piece[1:-1], 16)] = i
                continue
            if ptype in (_CONTROL, _UNKNOWN, _UNUSED):
                continue
            self.scores[piece] = score
            self.ids[piece] = i
            self._max_piece_len = max(self._max_piece_len, len(piece))
        self.engine = engine
        self._native = NativeUnigram(self.scores, self.ids, self.byte_pieces, self.unk_id) \
            if engine == "native" else None

    @classmethod
    def from_file(cls, model_file, max_length: int = 512, engine: str = "native"):
        with open(model_file, "rb") as f:
            data = f.read()
        pieces, trainer, normalizer = parse_model_proto(data)
        return cls(pieces, trainer, normalizer, max_length, engine)

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_piece)

    @property
    def eos_token(self) -> int:
        return self.eos_id

    @property
    def bos_token(self) -> int:
        return self.bos_id

    @property
    def pad_token(self) -> int:
        return self.pad_id

    # -------------------------------------------------- normalization

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", SPACE)

    # -------------------------------------------------- viterbi

    def _segment(self, text: str) -> list:
        """Unigram Viterbi over the normalized string → piece ids."""
        if self._native is not None:
            try:
                return self._native.segment(text)
            except ValueError:
                pass  # more pieces than the native buffer holds: the unbounded Python Viterbi
        return self._segment_py(text)

    def _segment_py(self, text: str) -> list:
        n = len(text)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back = [None] * (n + 1)  # (start, piece_id or None for unk-char)
        best[0] = 0.0
        max_len = self._max_piece_len
        for end in range(1, n + 1):
            lo = max(0, end - max_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                cand = text[start:end]
                score = self.scores.get(cand)
                if score is not None:
                    s = best[start] + score
                    if s > best[end]:
                        best[end] = s
                        back[end] = (start, self.ids[cand])
            if best[end] == NEG:
                # unknown single char: byte-fallback or unk, heavy penalty
                best[end] = best[end - 1] - 100.0
                back[end] = (end - 1, None)

        out = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid is not None:
                out.append(pid)
            else:
                ch = text[start:pos]
                b = ch.encode("utf-8")
                if self.byte_pieces:
                    out.extend(self.byte_pieces[x] for x in reversed(b))
                else:
                    out.append(self.unk_id)
            pos = start
        out.reverse()
        return out

    # -------------------------------------------------- public API

    def tokenize(self, text, prepend_bos: bool = True, append_eos: bool = True,
                 pad: bool = True):
        if isinstance(text, list):
            return [self.tokenize(t, prepend_bos, append_eos, pad) for t in text]
        tokens = self._segment(self._normalize(text))
        if prepend_bos and self.bos_id >= 0:
            tokens = [self.bos_id] + tokens
        if append_eos and self.eos_id >= 0:
            tokens.append(self.eos_id)
        if pad and self.pad_id >= 0 and len(tokens) < self.max_length:
            tokens = tokens + [self.pad_id] * (self.max_length - len(tokens))
        return tokens

    def encode(self, text, pad: bool = True):
        if not isinstance(text, list):
            return self.encode([text], pad=pad)
        rows = self.tokenize(text, pad=pad)
        pad_id = self.pad_id if self.pad_id >= 0 else 0
        length = max(len(r) for r in rows)
        return [r + [pad_id] * (length - len(r)) for r in rows]

    def decode(self, ids) -> str:
        out = []
        byte_buf = []
        inv_bytes = {v: k for k, v in self.byte_pieces.items()}
        for i in ids:
            if i in inv_bytes:
                byte_buf.append(inv_bytes[i])
                continue
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf = []
            if i in (self.pad_id, self.eos_id, self.bos_id):
                continue
            out.append(self.id_to_piece[i])
        if byte_buf:
            out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
        return "".join(out).replace(SPACE, " ").strip()
