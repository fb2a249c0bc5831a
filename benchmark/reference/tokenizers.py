"""Plain tokenizers for the reference: SentencePiece unigram (T5) and CLIP
byte-level BPE, read from the files under benchmark/assets.

They follow the published algorithms as the served program is expected to
run them: T5 normalises by NFKC, collapses whitespace, prepends the word
marker, segments by Viterbi over the piece scores (an unknown character
costs 100 and becomes `unk`), appends EOS and pads to `max_length` with
`pad` when asked; CLIP lowercases, splits words by CLIP's pattern, merges
each word by rank with a `</w>` end marker, wraps the ids in BOS / EOS and
caps them at 77 with EOS last. Nothing here imports the program.
"""

from __future__ import annotations

import json
import struct
import unicodedata

SPACE = "▁"
_BOS, _EOS = "<|startoftext|>", "<|endoftext|>"
_WORD_PAT = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"""
             r"""[^\s\p{L}\p{N}]+""")


def _varint(buf, i):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf):
    i = 0
    while i < len(buf):
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


class UnigramT5:
    """SentencePiece unigram over a `.model` ModelProto."""

    def __init__(self, path, max_length: int = 256):
        data = open(path, "rb").read()
        self.max_length = max_length
        self.scores, self.byte_ids = {}, {}
        ids = {"unk": 2, "bos": -1, "eos": 1, "pad": 0}
        self.dummy_prefix = True
        index = 0
        for field, wire, val in _fields(data):
            if field == 1 and wire == 2:
                piece, score, kind = "", 0.0, 1
                for f, _, v in _fields(val):
                    if f == 1:
                        piece = v.decode("utf-8")
                    elif f == 2:
                        score = struct.unpack("<f", v)[0]
                    elif f == 3:
                        kind = v
                if kind == 6:
                    self.byte_ids[int(piece[1:-1], 16)] = index
                elif kind == 1 or kind == 4:
                    self.scores[piece] = (score, index)
                index += 1
            elif field == 2 and wire == 2:
                for f, _, v in _fields(val):
                    v = v - (1 << 64) if isinstance(v, int) and v >= 1 << 63 else v
                    if f in (40, 41, 42, 43):
                        ids[("unk", "bos", "eos", "pad")[f - 40]] = v
            elif field == 3 and wire == 2:
                for f, _, v in _fields(val):
                    if f == 6:
                        self.dummy_prefix = bool(v)
        self.unk, self.bos, self.eos, self.pad = ids["unk"], ids["bos"], ids["eos"], ids["pad"]
        self.longest = max(len(p) for p in self.scores)

    def _viterbi(self, text):
        n = len(text)
        best = [0.0] + [float("-inf")] * n
        back = [None] * (n + 1)
        for end in range(1, n + 1):
            for start in range(max(0, end - self.longest), end):
                if best[start] == float("-inf"):
                    continue
                hit = self.scores.get(text[start:end])
                if hit is not None and best[start] + hit[0] > best[end]:
                    best[end], back[end] = best[start] + hit[0], (start, hit[1])
            if best[end] == float("-inf"):
                best[end], back[end] = best[end - 1] - 100.0, (end - 1, None)
        out, pos = [], n
        while pos > 0:
            start, pid = back[pos]
            if pid is not None:
                out.append(pid)
            elif self.byte_ids:
                out.extend(self.byte_ids[b] for b in reversed(text[start:pos].encode("utf-8")))
            else:
                out.append(self.unk)
            pos = start
        return out[::-1]

    def encode(self, text: str, pad: bool = True) -> list:
        text = " ".join(unicodedata.normalize("NFKC", text).split())
        if self.dummy_prefix and text:
            text = " " + text
        ids = self._viterbi(text.replace(" ", SPACE))
        if self.bos >= 0:
            ids = [self.bos] + ids
        if self.eos >= 0:
            ids.append(self.eos)
        if pad and self.pad >= 0 and len(ids) < self.max_length:
            ids += [self.pad] * (self.max_length - len(ids))
        return ids


def _byte_table():
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BpeCLIP:
    """CLIP byte-level BPE over Hugging Face `vocab.json` and `merges.txt`."""

    def __init__(self, folder, max_length: int = 77):
        import regex

        self.re = regex
        self.pattern = regex.compile(_WORD_PAT, regex.IGNORECASE)
        self.vocab = json.load(open(f"{folder}/vocab.json"))
        merges = [tuple(line.split()) for line in open(f"{folder}/merges.txt", encoding="utf-8")
                  if line.strip() and not line.startswith("#version")]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.bytes = _byte_table()
        self.max_length = max_length

    def _merge(self, word):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = min(zip(parts, parts[1:]), key=lambda p: self.ranks.get(p, float("inf")))
            if pair not in self.ranks:
                break
            out, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == pair:
                    out.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        return parts

    def encode(self, text: str) -> list:
        eos = self.vocab[_EOS]
        ids = [self.vocab[_BOS]]
        for word in self.pattern.findall(self.re.sub(r"\s+", " ", text.lower()).strip()):
            pieces = [word] if word in (_BOS, _EOS) else self._merge(
                "".join(self.bytes[b] for b in word.encode("utf-8")))
            ids += [self.vocab.get(p, eos) for p in pieces]
        ids.append(eos)
        if len(ids) > self.max_length:
            ids = ids[:self.max_length]
            ids[-1] = eos
        return ids
