"""MusicGen CLI (the port's counterpart of
flux_generator_tpu/cli/musicgen_generate.py, same flags and defaults).

python -m flux_generator_tpu_torch.cli.musicgen_generate [--model REPO]
  [--text TEXT] [--output-path 0.wav] [--max-steps N] [--top-k K]
  [--temp T] [--guidance G] [--seed S]

Runs on the current CUDA device, from the checkpoints in the local Hugging
Face hub cache (the repo, the T5 and the EnCodec repos its config names).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="facebook/musicgen-medium")
    parser.add_argument("--text", default="happy rock")
    parser.add_argument("--output-path", default="0.wav")
    parser.add_argument("--max-steps", type=int, default=500)
    parser.add_argument("--top-k", type=int, default=250)
    parser.add_argument("--temp", type=float, default=1.0)
    parser.add_argument("--guidance", type=float, default=3.0)
    parser.add_argument("--seed", type=int)
    return parser


def run(pipe, args):
    from ..utils.audio import save_audio

    audio = pipe.generate(args.text, max_steps=args.max_steps, top_k=args.top_k, temp=args.temp,
                          guidance_coef=args.guidance, seed=args.seed)
    save_audio(args.output_path, audio, pipe.sampling_rate)
    print(f"Saved audio to {args.output_path}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..pipelines.musicgen import MusicGenPipeline

    run(MusicGenPipeline.from_pretrained(args.model), args)


if __name__ == "__main__":
    main()
