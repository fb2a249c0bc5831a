"""T5 encoder-decoder generation CLI (the port's counterpart of
flux_generator_tpu/cli/t5_generate.py, same flags and defaults): greedy
decoding in f32 on the decoder's KV cache.

python -m flux_generator_tpu_torch.cli.t5_generate --prompt TEXT
  [--model t5-base] [--max-tokens N]

Runs on the current CUDA device, from the repo in the local Hugging Face hub
cache (config.json, model.safetensors, spiece.model).
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import torch


class T5Model(NamedTuple):
    params: dict
    cfg: object
    tokenizer: object


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="T5 text generation")
    parser.add_argument("--model", default="t5-base")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--max-tokens", type=int, default=128)
    return parser


def load(repo: str, device=None, local_dir=None) -> T5Model:
    """A full T5 (encoder, decoder, LM head) in f32 on `device` (the current
    CUDA device when None) from `repo` in the local hub cache, or from
    `local_dir`, held against the port's init_t5 shapes."""
    import json
    from pathlib import Path

    from ..io import sanitize
    from ..io.loaders import META, cast_tree, conform_params, hf_snapshot, t5_config
    from ..io.params import unflatten
    from ..io.safetensors import load_safetensors
    from ..models.t5.t5 import init_t5
    from ..runtime.device import as_device
    from ..tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer

    device = as_device(device)
    path = Path(local_dir) if local_dir else hf_snapshot(repo)
    with open(path / "config.json") as f:
        cfg = t5_config(json.load(f))
    flat = sanitize.sanitize_t5(load_safetensors(path / "model.safetensors"), decoder=True)
    params = conform_params(unflatten(flat, sanitize.T5_STACKS), init_t5(None, cfg, device=META), "t5")
    return T5Model(cast_tree(params, torch.float32, device), cfg,
                   SentencePieceUnigramTokenizer.from_file(path / "spiece.model"))


def greedy_tokens(params, cfg, tokenizer, text: str, max_tokens: int = 128) -> list:
    """The decoder's greedy token ids after `text` (EOS not included),
    starting from the pad id 0 (decoder_start_token_id)."""
    from ..models.t5.t5 import init_decode_cache, t5_decode, t5_encode

    device = params["wte"].device
    src = torch.tensor([tokenizer.tokenize(text, prepend_bos=False, append_eos=True, pad=False)],
                       dtype=torch.long, device=device)
    memory = t5_encode(params, cfg, src)
    cache = init_decode_cache(cfg, 1, max_tokens + 1, memory.dtype, device)
    tok = torch.zeros((1, 1), dtype=torch.long, device=device)
    out = []
    for _ in range(max_tokens):
        logits, cache = t5_decode(params, cfg, tok, memory, cache)
        nxt = int(logits[0, -1].argmax())
        if nxt == tokenizer.eos_token:
            break
        out.append(nxt)
        tok = torch.tensor([[nxt]], dtype=torch.long, device=device)
    return out


def generate_greedy(params, cfg, tokenizer, text: str, max_tokens: int = 128) -> str:
    return tokenizer.decode(greedy_tokens(params, cfg, tokenizer, text, max_tokens))


def run(model: T5Model, args) -> str:
    text = generate_greedy(model.params, model.cfg, model.tokenizer, args.prompt, args.max_tokens)
    print(text)
    return text


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(load(args.model), args)


if __name__ == "__main__":
    main()
