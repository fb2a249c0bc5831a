"""img2img CLI (the port's counterpart of flux_generator_tpu/cli/image2image.py,
same flags and defaults: SDXL-Turbo at strength 0.9).

python -m flux_generator_tpu_torch.cli.image2image IMAGE "PROMPT"
  [--model sd|sdxl] [--strength S] [--n_images N] [--steps N] [--cfg W]
  [--seed S] [--output out.png]

Runs on the current CUDA device, from the checkpoints in the local Hugging
Face hub cache.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .sd_txt2image import load, steps_and_cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Modify an image given a prompt (img2img)"
    )
    parser.add_argument("image")
    parser.add_argument("prompt")
    parser.add_argument("--model", choices=["sd", "sdxl"], default="sdxl")
    parser.add_argument("--strength", type=float, default=0.9)
    parser.add_argument("--n_images", type=int, default=4)
    parser.add_argument("--steps", type=int)
    parser.add_argument("--cfg", type=float)
    parser.add_argument("--negative_prompt", default="")
    parser.add_argument("--n_rows", type=int, default=1)
    parser.add_argument("--output", default="out.png")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--verbose", "-v", action="store_true")
    return parser


def read_image(path) -> torch.Tensor:
    """The image at `path`, its sides cut down to multiples of 64 by a
    resize, as (H, W, 3) f32 in [-1, 1]."""
    from PIL import Image

    img = Image.open(path)
    w, h = img.size
    img = img.resize((64 * (w // 64), 64 * (h // 64)))
    return torch.from_numpy(np.array(img.convert("RGB"))).float() / 255 * 2 - 1


def generate(pipe, args) -> np.ndarray:
    """The images (n, H, W, 3) uint8, each decoded alone."""
    steps, cfg = steps_and_cfg(args)
    x_t = None
    for x_t in pipe.generate_latents_from_image(
        read_image(args.image), args.prompt, n_images=args.n_images, strength=args.strength,
        num_steps=steps, cfg_weight=cfg, negative_text=args.negative_prompt, seed=args.seed,
    ):
        pass
    return np.concatenate([pipe.decode_u8(x_t[i:i + 1]).cpu().numpy() for i in range(args.n_images)], axis=0)


def run(pipe, args):
    from ..utils.images import save_image_grid

    save_image_grid(args.output, generate(pipe, args), rows=args.n_rows)
    print(f"Saved to {args.output}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(load(args.model), args)


if __name__ == "__main__":
    main()
