"""SD / SDXL CLI (the port's counterpart of
flux_generator_tpu/cli/sd_txt2image.py, same flags and defaults: SDXL-Turbo
at 2 steps without CFG, or SD 2.1-base at 50 steps, cfg 7.5).

python -m flux_generator_tpu_torch.cli.sd_txt2image "PROMPT" [--model sd|sdxl]
  [--n_images N] [--steps N] [--cfg W] [--negative_prompt TEXT] [--quantize]
  [--seed S] [--output out.png]

Runs on the current CUDA device, from the checkpoints in the local Hugging
Face hub cache.
"""

from __future__ import annotations

import argparse

import numpy as np

REPOS = {"sdxl": "stabilityai/sdxl-turbo", "sd": "stabilityai/stable-diffusion-2-1-base"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate images from a textual prompt using stable diffusion"
    )
    parser.add_argument("prompt")
    parser.add_argument("--model", choices=["sd", "sdxl"], default="sdxl")
    parser.add_argument("--n_images", type=int, default=4)
    parser.add_argument("--steps", type=int)
    parser.add_argument("--cfg", type=float)
    parser.add_argument("--negative_prompt", default="")
    parser.add_argument("--n_rows", type=int, default=1)
    parser.add_argument("--decoding_batch_size", type=int, default=1)
    parser.add_argument("--quantize", "-q", action="store_true")
    parser.add_argument("--preload-models", action="store_true")
    parser.add_argument("--output", default="out.png")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--verbose", "-v", action="store_true")
    return parser


def steps_and_cfg(args):
    """The model's defaults where the flags leave them out."""
    if args.model == "sdxl":
        return args.steps or 2, (args.cfg if args.cfg is not None else 0.0)
    return args.steps or 50, (args.cfg if args.cfg is not None else 7.5)


def load(model: str, quantize: bool = False, **kwargs):
    """The pipeline of --model (SDXL-Turbo or SD 2.1-base) through its
    from_pretrained, int8 with `quantize`."""
    from ..pipelines.sd import StableDiffusion, StableDiffusionXL

    cls = StableDiffusionXL if model == "sdxl" else StableDiffusion
    pipe = cls.from_pretrained(REPOS[model], **kwargs)
    if quantize:
        from ..ops.quant import quantize_pipeline

        quantize_pipeline(pipe)
    return pipe


def generate(pipe, args) -> np.ndarray:
    """The images (n, H, W, 3) uint8, decoded `decoding_batch_size` at a time."""
    steps, cfg = steps_and_cfg(args)
    x_t = None
    for x_t in pipe.generate_latents(
        args.prompt, n_images=args.n_images, num_steps=steps, cfg_weight=cfg,
        negative_text=args.negative_prompt, seed=args.seed,
    ):
        pass
    images = [pipe.decode_u8(x_t[i:i + args.decoding_batch_size]).cpu().numpy()
              for i in range(0, args.n_images, args.decoding_batch_size)]
    return np.concatenate(images, axis=0)


def run(pipe, args):
    from ..utils.images import save_image_grid

    save_image_grid(args.output, generate(pipe, args), rows=args.n_rows)
    print(f"Saved {args.n_images} image(s) to {args.output}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(load(args.model, args.quantize), args)


if __name__ == "__main__":
    main()
