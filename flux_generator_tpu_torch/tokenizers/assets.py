"""Tokenizer asset writers (the port's own copy of
flux_generator_tpu/tokenizers/assets.py): files in the real wire formats
that the tokenizers parse — Hugging Face `vocab.json`/`merges.txt` for CLIP
BPE, learned from a corpus by byte-level BPE, and a serialized SentencePiece
ModelProto (`.model`) for T5 — so that the disk → parse → tokenize path runs
end to end without downloaded assets. `learn_bpe` needs the `regex` module,
imported when it runs.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

from .clip_bpe import BOS, EOS, bytes_to_unicode


# ------------------------------------------------------------ CLIP BPE learn


def learn_bpe(corpus, num_merges: int):
    """Standard byte-level BPE learning (the algorithm behind the real CLIP
    vocab): start from the 256-char byte alphabet (+ `</w>` word-final
    variants), repeatedly merge the most frequent adjacent pair.

    Returns (vocab: token→id, merges: list of (a, b) in rank order) with the
    same layout as OpenAI's CLIP vocab: bytes, byte+`</w>`, merged tokens in
    rank order, then BOS/EOS at the end.
    """
    import regex

    from .clip_bpe import _WORD_PAT

    byte_enc = bytes_to_unicode()
    word_freq = collections.Counter()
    for text in corpus:
        clean = regex.sub(r"\s+", " ", text.lower()).strip()
        for w in regex.findall(_WORD_PAT, clean):
            if w in (BOS, EOS):
                continue
            word_freq["".join(byte_enc[b] for b in w.encode("utf-8"))] += 1

    # each word as its symbol sequence: chars, last char + </w>
    words = {
        w: tuple(list(w[:-1]) + [w[-1] + "</w>"]) for w in word_freq
    }

    merges = []
    for _ in range(num_merges):
        pair_freq = collections.Counter()
        for w, sym in words.items():
            f = word_freq[w]
            for a, b in zip(sym, sym[1:]):
                pair_freq[(a, b)] += f
        if not pair_freq:
            break
        # most frequent pair; ties broken lexicographically for determinism
        best = max(pair_freq.items(), key=lambda kv: (kv[1], kv[0]))[0]
        if pair_freq[best] < 2:
            break
        merges.append(best)
        merged_tok = best[0] + best[1]
        new_words = {}
        for w, sym in words.items():
            out, i = [], 0
            while i < len(sym):
                if i < len(sym) - 1 and (sym[i], sym[i + 1]) == best:
                    out.append(merged_tok)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            new_words[w] = tuple(out)
        words = new_words

    chars = list(byte_enc.values())
    tokens = chars + [c + "</w>" for c in chars]
    tokens += [a + b for a, b in merges]
    tokens += [BOS, EOS]
    vocab = {t: i for i, t in enumerate(tokens)}
    return vocab, merges


def write_clip_assets(out_dir, corpus, num_merges: int = 512):
    """Write HF-format `vocab.json` + `merges.txt` (with the `#version`
    header line HF unconditionally skips) learned from `corpus`."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    vocab, merges = learn_bpe(corpus, num_merges)
    with open(out_dir / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False, indent=0)
    with open(out_dir / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vocab, merges


# ------------------------------------------------------ SentencePiece writer


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # protobuf negative int32/int64 → 10-byte varint
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2, _varint(len(payload)) + payload)


# piece types (sentencepiece_model.proto SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def serialize_model_proto(pieces, trainer=None, normalizer=None) -> bytes:
    """Serialize a SentencePiece ModelProto (the `.model` wire format).

    pieces: list of (piece: str, score: float, type: int).
    trainer: dict with optional model_type / vocab_size / unk_id / bos_id /
    eos_id / pad_id / byte_fallback. normalizer: dict with optional name /
    add_dummy_prefix / remove_extra_whitespaces / escape_whitespaces.
    Field numbers follow sentencepiece_model.proto exactly, so the output is
    loadable by the real `sentencepiece` library as well as our parser.
    """
    import struct

    blob = b""
    for piece, score, ptype in pieces:
        body = _len_field(1, piece.encode("utf-8"))
        body += _field(2, 5, struct.pack("<f", score))
        if ptype != NORMAL:
            body += _field(3, 0, _varint(ptype))
        blob += _len_field(1, body)

    t = dict(trainer or {})
    ts = b""
    # model_type: 1=unigram (TrainerSpec field 3)
    ts += _field(3, 0, _varint(t.get("model_type", 1)))
    if "vocab_size" in t:
        ts += _field(4, 0, _varint(t["vocab_size"]))
    if t.get("byte_fallback"):
        ts += _field(35, 0, _varint(1))
    ts += _field(40, 0, _varint(t.get("unk_id", 2)))
    ts += _field(41, 0, _varint(t.get("bos_id", -1)))
    ts += _field(42, 0, _varint(t.get("eos_id", 1)))
    ts += _field(43, 0, _varint(t.get("pad_id", 0)))
    blob += _len_field(2, ts)

    nz = dict(normalizer or {})
    ns = _len_field(1, nz.get("name", "identity").encode())
    # NormalizerSpec: add_dummy_prefix=6, remove_extra_whitespaces=7,
    # escape_whitespaces=8 (all default true in real models)
    ns += _field(6, 0, _varint(1 if nz.get("add_dummy_prefix", True) else 0))
    ns += _field(7, 0, _varint(1 if nz.get("remove_extra_whitespaces", True) else 0))
    ns += _field(8, 0, _varint(1 if nz.get("escape_whitespaces", True) else 0))
    blob += _len_field(3, ns)
    return blob


def build_unigram_pieces(vocab_scores, byte_fallback: bool = False):
    """T5-style piece inventory: `<pad>` `</s>` `<unk>` controls first (ids
    0/1/2 — the real t5 spiece.model layout), then optional `<0x00>`-`<0xFF>`
    byte pieces, then the scored vocabulary."""
    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN)]
    if byte_fallback:
        pieces += [(f"<0x{i:02X}>", 0.0, BYTE) for i in range(256)]
    pieces += [(p, float(s), NORMAL) for p, s in vocab_scores]
    return pieces


def write_spiece_model(out_path, vocab_scores, byte_fallback: bool = False,
                       trainer=None, normalizer=None):
    """Write a complete `.model` file with T5-style special-token layout."""
    pieces = build_unigram_pieces(vocab_scores, byte_fallback)
    t = {"unk_id": 2, "bos_id": -1, "eos_id": 1, "pad_id": 0,
         "vocab_size": len(pieces), "byte_fallback": byte_fallback}
    t.update(trainer or {})
    data = serialize_model_proto(pieces, t, normalizer)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_bytes(data)
    return pieces
