"""Tokenizer loaders over the port's tokenizers
(`flux_generator_tpu_torch/tokenizers/`): SentencePiece unigram for T5 and
byte-level BPE for CLIP (which needs the `regex` module), on their native
engines unless engine="python"."""

from __future__ import annotations

from ..tokenizers.clip_bpe import CLIPTokenizer
from ..tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer


def load_t5_tokenizer(model_file, max_length: int = 256, engine: str = "native"):
    """A SentencePiece `.model` file → tokenizer padding to `max_length`
    (256 for flux-schnell, 512 for flux-dev)."""
    return SentencePieceUnigramTokenizer.from_file(model_file, max_length=max_length, engine=engine)


def load_clip_tokenizer(vocab_file, merges_file, max_length: int = 77, engine: str = "native"):
    """HF-format vocab.json + merges.txt → CLIP BPE tokenizer. Raises
    ImportError where the `regex` module is missing."""
    return CLIPTokenizer.from_files(vocab_file, merges_file, max_length=max_length, engine=engine)
