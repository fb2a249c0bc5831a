"""Tokenizer loaders. The tokenizers themselves are the JAX package's
pure-Python ones (no jax inside), imported here when a loader is called:
SentencePiece unigram for T5 and byte-level BPE for CLIP (which needs the
`regex` module)."""

from __future__ import annotations


def load_t5_tokenizer(model_file, max_length: int = 256):
    """A SentencePiece `.model` file → tokenizer padding to `max_length`
    (256 for flux-schnell, 512 for flux-dev)."""
    from flux_generator_tpu.tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer

    return SentencePieceUnigramTokenizer.from_file(model_file, max_length=max_length)


def load_clip_tokenizer(vocab_file, merges_file, max_length: int = 77):
    """HF-format vocab.json + merges.txt → CLIP BPE tokenizer. Raises
    ImportError where the `regex` module is missing."""
    from flux_generator_tpu.tokenizers.clip_bpe import CLIPTokenizer

    return CLIPTokenizer.from_files(vocab_file, merges_file, max_length=max_length)
