"""DreamBooth LoRA fine-tuning of Flux (counterpart of
flux_generator_tpu/training/dreambooth.py, with the same flags).

Gradients are taken over the extracted LoRA tree only: the base (bf16 or
int8 with --quantize-base) never requires grad. Adam with optax's defaults
on a linear-warmup → cosine schedule, gradient accumulation over
--grad-accumulate micro-steps, an optional last-N-blocks mask, the "block"
or "dots" recomputation policy (--remat-policy), adapter safetensors and
torch.save train-state checkpoints.

Data-parallel over processes: under `torchrun` (or after
parallel.distributed.initialize_multihost) every process iterates the same
global batch and takes its rows of it, the LoRA gradients are averaged
across the processes (all_reduce, then divided by their number), and
process 0 alone writes files. Each process runs on the device its pipeline
lies on (the card unless the caller built the pipeline on the CPU).
Loading Flux checkpoints is not ported here: from the command line the
trainer runs on seeded random weights at the model's full width
(--random-weights), with the tokenizers read from files.

    python -m flux_generator_tpu_torch.training.dreambooth DATASET --model dev \
        --random-weights --t5-tokenizer spiece.model --clip-tokenizer DIR \
        --quantize-base ...
    torchrun --nproc-per-node 4 -m flux_generator_tpu_torch.training.dreambooth DATASET ...
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..io.params import tree_leaves, tree_map
from ..parallel.mesh import DATA_AXIS, all_reduce, create_mesh
from .lora import merge_lora


def warmup_cosine(learning_rate: float, warmup: int, total: int):
    """optax.join_schedules([linear 0 → lr over `warmup`, cosine decay of lr
    over total − warmup], [warmup]) as a function of the update count."""
    decay = max(total - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return learning_rate * count / warmup
        s = min(count - warmup, decay)
        return learning_rate * 0.5 * (1 + math.cos(math.pi * s / decay))

    return schedule


class Adam:
    """optax.adam(schedule) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a
    tree of tensors, updating params and moments in place. The schedule
    sees the update count before the update, so the first update uses
    schedule(0). Moments take the params' dtype, as optax's do."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state: dict, params) -> dict:
        """Apply one update to `params` in place; returns the new state."""
        count = state["count"]
        lr = self.schedule(count)
        bc1 = 1 - self.b1 ** (count + 1)
        bc2 = 1 - self.b2 ** (count + 1)
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            g = g.to(mu.dtype)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_((u * -lr).to(p.dtype))
        return {**state, "count": count + 1}


def build_optimizer(learning_rate: float, warmup: int, total: int) -> Adam:
    return Adam(warmup_cosine(learning_rate, warmup, total))


def _mean_over_data(tensors: list, mesh) -> list:
    """Each tensor averaged over the mesh's "data" axis: summed (gloo has no
    average) in one flat buffer a dtype, then divided by the axis size."""
    n = mesh.size(DATA_AXIS)
    out = list(tensors)
    for dtype in {t.dtype for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce(flat, mesh, DATA_AXIS)
        flat = flat / n
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def make_train_step(pipeline, optimizer: Adam, base_params, grad_accumulate: int, block_mask=None,
                    remat: str = "block", mesh=None):
    """A step over the extracted LoRA tree: the loss of one micro-batch and
    its gradients with respect to the LoRA leaves only, times `block_mask`
    (per-leaf 0/1 multipliers over the stacked layer axis) when given,
    summed into `accum`; on `should_step` one optimizer update on
    accum / grad_accumulate, and accum starts again at zero. The flow
    recomputes its blocks by the `remat` policy.

    With a mesh whose "data" axis has more than one rank, every rank gets
    the same global batch, takes the loss over its rows of it, and the loss
    and gradients are averaged over the axis, so every rank steps alike."""
    mask = tree_leaves(block_mask) if block_mask is not None else None
    n_data = 1 if mesh is None else mesh.size(DATA_AXIS)

    def step(lora_params, opt_state, accum, generator, x0, t5f, clipf, guidance,
             is_first: bool, should_step: bool):
        leaves = tree_leaves(lora_params)
        # only what differs from training_loss's defaults: a pipeline with the
        # six-argument training_loss trains as before
        kw = {} if remat == "block" else {"remat": remat}
        if n_data > 1:
            if x0.shape[0] % n_data:
                raise ValueError(f"a batch of {x0.shape[0]} rows does not split over {n_data} processes")
            per = x0.shape[0] // n_data
            kw["rows"] = slice(mesh.index(DATA_AXIS) * per, (mesh.index(DATA_AXIS) + 1) * per)
        loss = pipeline.training_loss(merge_lora(base_params, lora_params), generator, x0, t5f,
                                      clipf, guidance, **kw)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if n_data > 1:
            loss, *grads = _mean_over_data([loss, *grads], mesh)
        if mask is not None:
            grads = [g * m for g, m in zip(grads, mask)]
        if is_first or accum is None:
            accum = grads
        else:
            accum = [a + g for a, g in zip(accum, grads)]
        if should_step:
            it = iter([a / grad_accumulate for a in accum])
            opt_state = optimizer.update(tree_map(lambda _: next(it), lora_params), opt_state,
                                         lora_params)
            accum = [torch.zeros_like(a) for a in accum]
        return loss, lora_params, opt_state, accum

    return step


@torch.no_grad()
def generate_progress_images(pipeline, prompt: str, out_dir: Path, step: int,
                             n_images: int = 4, latent_size=(32, 32)):
    from ..utils.images import save_image_grid

    images = pipeline.generate_images(
        prompt, n_images=n_images, num_steps=2 if pipeline.schnell else 35,
        latent_size=latent_size, seed=42,
    )
    out_file = out_dir / f"{step:07d}_progress.png"
    save_image_grid(str(out_file), images, rows=1)
    print(f"Saved {out_file}", flush=True)


def random_pipeline(args):
    """Flux-`args.model` at full width on seeded random weights on
    `args.device` (the card when None), T5-XXL in int4 g128 as the serving
    benchmark runs it, with the tokenizers read from the files the args
    name."""
    from ..io.registry import FLUX_T5_MAX_LENGTH
    from ..io.tokenizers import load_clip_tokenizer, load_t5_tokenizer
    from ..ops.quant import quantize_tree
    from ..pipelines.flux import FluxPipeline
    from ..runtime.device import as_device

    if not args.random_weights:
        raise NotImplementedError("loading Flux checkpoints is not ported yet: pass --random-weights "
                                  "(seeded random weights at full width) or a FluxPipeline")
    if not (args.t5_tokenizer and args.clip_tokenizer):
        raise ValueError("--random-weights needs --t5-tokenizer and --clip-tokenizer")
    name = "flux-" + args.model
    pipe = FluxPipeline.random_init(name, device=as_device(args.device))
    pipe.params["t5"] = quantize_tree(pipe.params["t5"], bits=4, group_size=128, pack=True)
    pipe.t5_tokenizer = load_t5_tokenizer(args.t5_tokenizer, max_length=FLUX_T5_MAX_LENGTH[name])
    clip_dir = Path(args.clip_tokenizer)
    pipe.clip_tokenizer = load_clip_tokenizer(clip_dir / "vocab.json", clip_dir / "merges.txt")
    return pipe


def train(args, pipeline=None, dataset=None, trace: Optional[dict] = None):
    """Fine-tune `pipeline` (a FluxPipeline, whose device the run takes; from
    `random_pipeline(args)` when None) on `dataset` (loaded from
    args.dataset when None) and write the adapters under args.output_dir.
    `trace`, when a dict is given, receives the seconds of the dataset
    encode ("encode_s") and of each micro-step ("micro_step_s"), each ended
    by a device synchronize, and the losses."""
    from ..ops.quant import quantize_tree
    from ..parallel.distributed import initialize_multihost, process_info
    from ..runtime.device import synchronize
    from .checkpoints import load_train_state, save_adapter, save_config, save_train_state
    from .datasets import load_dataset
    from .lora import apply_lora_to_flux, extract_lora, lora_block_mask
    from .trainer import Trainer

    # join the other processes (a no-op in a single process) before the
    # pipeline is built on this process's device
    initialize_multihost(device=pipeline.device if pipeline is not None else args.device)
    pinfo = process_info()
    if pinfo["process_count"] > 1:
        print(f"multi-process training: {pinfo}", flush=True)
    is_main = pinfo["process_index"] == 0  # process 0 owns all file output
    if pipeline is None:
        pipeline = random_pipeline(args)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if is_main:
        save_config(output_dir / "adapter_config.json", vars(args))
    if dataset is None:
        dataset = load_dataset(args.dataset)
    device = pipeline.device

    # deterministic LoRA init from a fixed seed, alike on every process
    flow = apply_lora_to_flux(pipeline.params["flow"], rank=args.lora_rank,
                              generator=torch.Generator(device=device).manual_seed(0x0F0F0F0F))
    if getattr(args, "quantize_base", False):
        # the frozen base in int8; the adapters keep the working dtype
        flow = quantize_tree(flow)
        print("quantized frozen base weights to int8", flush=True)
    cfg = pipeline.flow_cfg
    block_mask = lora_block_mask(flow, args.lora_blocks, cfg.depth, cfg.depth_single_blocks)
    pipeline.params["flow"] = flow

    lora = extract_lora(flow)
    optimizer = build_optimizer(args.learning_rate, args.warmup_steps, args.iterations)
    opt_state = optimizer.init(lora)
    start_iter = 0
    if getattr(args, "resume", False):
        restored = load_train_state(output_dir / "ckpt", lora, opt_state)
        if restored is not None:
            start_iter, lora, opt_state = restored
            print(f"Resumed from step {start_iter}", flush=True)
    for p in tree_leaves(lora):
        p.requires_grad_(True)

    # the data axis must divide the global batch: processes past it sit out
    # (the reference requires the same, one batch shard a rank)
    world = pinfo["process_count"]
    n_data = math.gcd(args.batch_size, world)
    if n_data < world:
        print(f"WARNING: batch size {args.batch_size} not divisible by {world} processes; "
              f"training on {n_data}", flush=True)
    mesh = create_mesh(data=n_data, model=1, devices=range(n_data))
    training = mesh.coords is not None
    step_fn = make_train_step(
        pipeline, optimizer, flow, args.grad_accumulate,
        block_mask=extract_lora(block_mask) if args.lora_blocks > 0 else None,
        remat=args.remat_policy, mesh=mesh,
    )

    trainer = Trainer(pipeline, dataset, resolution=args.resolution,
                      num_augmentations=args.num_augmentations)
    t0 = time.perf_counter()
    trainer.encode_dataset()
    if trace is not None:
        synchronize(device)
        trace.update(encode_s=time.perf_counter() - t0, micro_step_s=[], losses=[])

    guidance = (torch.full((args.batch_size,), args.guidance, dtype=pipeline.dtype, device=device)
                if cfg.guidance_embed else None)
    accum = None
    generator = torch.Generator(device=device).manual_seed(0xF0F0F0F0)

    losses, tic = [], time.time()
    steps = range(start_iter * args.grad_accumulate, args.iterations * args.grad_accumulate)
    for i, (x0, t5f, clipf) in zip(steps if training else (), trainer.iterate(args.batch_size)):
        t0 = time.perf_counter()
        is_first = (i % args.grad_accumulate) == 0
        should_step = (i % args.grad_accumulate) == (args.grad_accumulate - 1)
        loss, lora, opt_state, accum = step_fn(
            lora, opt_state, accum, generator, x0, t5f, clipf, guidance,
            is_first=is_first, should_step=should_step,
        )
        pipeline.params["flow"] = merge_lora(flow, lora)
        losses.append(float(loss))  # waits for the device
        if trace is not None:
            trace["micro_step_s"].append(time.perf_counter() - t0)
            trace["losses"].append(losses[-1])

        opt_step = (i + 1) // args.grad_accumulate
        if should_step and opt_step % 10 == 0:
            toc = time.time()
            print(f"Iter: {opt_step} Loss: {np.mean(losses):.5f} "
                  f"It/s: {10 * args.grad_accumulate / (toc - tic):.3f}", flush=True)
            losses, tic = [], toc
        if is_main and should_step and args.progress_every > 0 and opt_step % args.progress_every == 0:
            generate_progress_images(pipeline, args.progress_prompt, output_dir, opt_step)
        if is_main and should_step and args.checkpoint_every > 0 and opt_step % args.checkpoint_every == 0:
            save_adapter(output_dir / f"{opt_step:07d}_adapters.safetensors",
                         merge_lora(flow, lora), args.lora_rank, args.lora_blocks)
            if getattr(args, "resume", False) or getattr(args, "save_state", False):
                save_train_state(output_dir / "ckpt", opt_step, lora, opt_state)
    if n_data < world:
        # the processes that sat out take the trained adapters of process 0
        with torch.no_grad():
            for p in tree_leaves(lora):
                torch.distributed.broadcast(p, src=0)
        pipeline.params["flow"] = merge_lora(flow, lora)
    if is_main:
        save_adapter(output_dir / "final_adapters.safetensors", merge_lora(flow, lora),
                     args.lora_rank, args.lora_blocks)
    return pipeline


def build_parser():
    parser = argparse.ArgumentParser(description="Finetune Flux with LoRA (DreamBooth-style)")
    parser.add_argument("dataset")
    parser.add_argument("--model", default="dev", choices=["dev", "schnell"])
    parser.add_argument("--guidance", type=float, default=3.0)
    parser.add_argument("--iterations", type=int, default=600)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--resolution", type=lambda x: tuple(map(int, x.split("x"))),
                        default=(512, 512))
    parser.add_argument("--num-augmentations", type=int, default=5)
    parser.add_argument("--progress-prompt", default="")
    parser.add_argument("--progress-every", type=int, default=50)
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--lora-rank", type=int, default=8)
    parser.add_argument("--lora-blocks", type=int, default=-1)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--warmup-steps", type=int, default=100)
    parser.add_argument("--grad-accumulate", type=int, default=4)
    parser.add_argument("--output-dir", default="tpu_output")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest train-state checkpoint")
    parser.add_argument("--save-state", action="store_true",
                        help="write train-state checkpoints alongside adapters")
    parser.add_argument("--quantize-base", action="store_true",
                        help="int8-quantize the frozen base weights")
    parser.add_argument("--remat-policy", default="block", choices=["block", "dots"],
                        help="recompute each flow block whole in the backward pass (block), or save the "
                             "outputs of its 2-D matmuls and recompute the rest (dots)")
    # the port's own: checkpoint loading is not ported yet, so this flag is
    # required; it stands as a guard that the caller knows the weights are random
    parser.add_argument("--random-weights", action="store_true",
                        help="required until checkpoint loading is ported: acknowledges that "
                             "Flux is trained at full width on seeded random weights")
    parser.add_argument("--t5-tokenizer", help="SentencePiece .model file (with --random-weights)")
    parser.add_argument("--clip-tokenizer",
                        help="directory of the CLIP vocab.json and merges.txt (with --random-weights)")
    parser.add_argument("--device", help="torch device (default: the current CUDA device)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.progress_prompt:
        args.progress_prompt = "photo"
    train(args)


if __name__ == "__main__":
    main()
