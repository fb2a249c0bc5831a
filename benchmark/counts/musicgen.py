"""Operations and bytes of MusicGen's autoregressive steps, from the
configuration's shapes (`benchmark/configs/musicgen-medium.json`), with bf16
weights and caches. Every product counts 2·M·N·K."""

from __future__ import annotations


def layer_weight_bytes(dec: dict) -> int:
    """A decoder layer's weights that a step reads: self-attention q, k, v
    and o, cross-attention q and o (its k and v act on the fixed text, once
    a request), the feed-forward pair, three LayerNorms."""
    h, f = dec["hidden_size"], dec["ffn_dim"]
    return 2 * (6 * h * h + 2 * h * f + 6 * h)


def decode_launch(dec: dict, rows: int, offset: int, text: int):
    """(operations, bytes) of one fused decoder step over `rows` CFG rows at
    position `offset` with `text` conditioning positions: the layers'
    weights read once, the offset + 1 live rows of the K and V caches and
    the text K and V read, the new K and V rows written."""
    h, f, n = dec["hidden_size"], dec["ffn_dim"], dec["num_hidden_layers"]
    live = offset + 1
    flops = n * rows * (2 * h * 6 * h + 4 * h * f + 4 * live * h + 4 * text * h)
    nbytes = n * (layer_weight_bytes(dec) + 2 * rows * (2 * live * h + 2 * text * h + 2 * h)) + 4 * rows * h
    return flops, nbytes


def step(dec: dict, rows: int, offset: int, text: int):
    """(operations, bytes) of a whole AR step: the fused step and the four
    output heads (their weights read once)."""
    flops, nbytes = decode_launch(dec, rows, offset, text)
    heads = dec["num_codebooks"] * dec["hidden_size"] * dec["codebook_size"]
    return flops + 2 * rows * heads, nbytes + 2 * heads


def request_steps(dec: dict, rows: int, steps: int, text: int, launch: bool = False):
    """[(operations, bytes)] of each of a request's `steps` steps."""
    fn = decode_launch if launch else step
    return [fn(dec, rows, t, text) for t in range(steps)]
