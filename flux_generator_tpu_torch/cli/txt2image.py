"""Flux CLI (the port's counterpart of flux_generator_tpu/cli/txt2image.py,
same flags and defaults).

python -m flux_generator_tpu_torch.cli.txt2image "PROMPT" [--model schnell|dev]
  [--n-images N] [--image-size WxH] [--steps N] [--guidance G] [--seed S]
  [--adapter FILE [--fuse-adapter]] [--quantize] [--no-t5-padding]
  [--output out.png] [--save-raw] [--verbose]

Runs on the current CUDA device, from the checkpoints in the local Hugging
Face hub cache (or the FLUX_SCHNELL / FLUX_DEV / AE files).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate images from a textual prompt using Flux"
    )
    parser.add_argument("prompt")
    parser.add_argument("--model", choices=["schnell", "dev"], default="schnell")
    parser.add_argument("--n-images", type=int, default=4)
    parser.add_argument("--image-size", type=lambda x: tuple(map(int, x.split("x"))),
                        default=(512, 512))
    parser.add_argument("--steps", type=int)
    parser.add_argument("--guidance", type=float, default=4.0)
    parser.add_argument("--n-rows", type=int, default=1)
    parser.add_argument("--decoding-batch-size", type=int, default=1)
    parser.add_argument("--quantize", "-q", action="store_true")
    parser.add_argument("--no-t5-padding", dest="t5_padding", action="store_false")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--adapter")
    parser.add_argument("--fuse-adapter", action="store_true")
    parser.add_argument("--output", default="out.png")
    parser.add_argument("--save-raw", action="store_true")
    parser.add_argument("--verbose", "-v", action="store_true")
    return parser


def load_adapter(pipeline, adapter_file: str, fuse: bool = False):
    """Load a DreamBooth LoRA adapter file (with its lora_rank metadata)
    into the pipeline."""
    from ..training.checkpoints import load_adapter_file

    load_adapter_file(pipeline, adapter_file, fuse=fuse)


def generate(pipeline, args) -> np.ndarray:
    """The images (n, H, W, 3) uint8, `decoding_batch_size` at a time, the
    batch starting at image i seeded seed + i."""
    steps = args.steps or (50 if args.model == "dev" else 2)
    w, h = args.image_size
    latent_size = (h // 8, w // 8)
    images = []
    for i in range(0, args.n_images, args.decoding_batch_size):
        n = min(args.decoding_batch_size, args.n_images - i)
        batch = pipeline.generate_images(
            args.prompt, n_images=n, num_steps=steps, guidance=args.guidance,
            latent_size=latent_size, seed=None if args.seed is None else args.seed + i,
            as_uint8=True,  # pixels quantize on the device; 4x smaller fetch
        )
        images.append(batch.cpu().numpy())
        if args.verbose:
            print(f"generated {i + n}/{args.n_images}", flush=True)
    return np.concatenate(images, axis=0)


def run(pipeline, args):
    """Generate and write the grid (or each image with --save-raw)."""
    from ..utils.images import save_image_grid, to_pil

    images = generate(pipeline, args)
    if args.save_raw:
        stem = args.output.rsplit(".", 1)[0]
        for i, im in enumerate(to_pil(images)):
            im.save(f"{stem}_{i}.png")
    else:
        save_image_grid(args.output, images, rows=args.n_rows)
    print(f"Saved {args.n_images} image(s) to {args.output}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..pipelines.flux import FluxPipeline

    pipeline = FluxPipeline.from_pretrained("flux-" + args.model)
    if args.adapter:
        load_adapter(pipeline, args.adapter, fuse=args.fuse_adapter)
    if args.quantize:
        from ..ops.quant import quantize_pipeline

        quantize_pipeline(pipeline)
    run(pipeline, args)


if __name__ == "__main__":
    main()
