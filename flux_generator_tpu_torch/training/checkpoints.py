"""Adapter and train-state checkpoints (counterpart of
flux_generator_tpu/training/checkpoints.py).

Adapter files are safetensors holding the stacked LoRA tensors in f32 under
their dotted paths ("double_blocks.img_attn.qkv.lora_a"), with the metadata
lora_rank, lora_blocks and format, as the JAX package writes them, through
the port's own safetensors reader and writer (io/safetensors.py). Train
state (step, LoRA tree, optimizer state) goes through torch.save where the
JAX package uses orbax.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..io import safetensors as st
from ..io.params import tree_leaves, tree_map

FORMAT = "flux_generator_tpu.stacked.v1"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def extract_lora_flat(flow_params) -> dict:
    """{dotted path: tensor} of the lora_a/lora_b leaves."""
    return {k: v for k, v in _flatten(flow_params).items() if k.endswith((".lora_a", ".lora_b"))}


def load_safetensors(path):
    """→ ({name: tensor}, metadata dict) of an adapter file."""
    return st.load_safetensors(path), st.read_header(path)[2]


def save_adapter(path, flow_params, rank: int, num_blocks: int):
    """Write the LoRA adapter safetensors (f32) with its metadata."""
    flat = {k: v.detach().float() for k, v in extract_lora_flat(flow_params).items()}
    st.save_safetensors(path, flat, {"lora_rank": rank, "lora_blocks": num_blocks, "format": FORMAT})


def load_adapter_file(pipeline, path, fuse: bool = False):
    """Load an adapter into a FluxPipeline: inject LoRA at the recorded rank
    where the flow has none, overwrite the lora tensors (cast to the flow's
    adapter dtype, on its device), optionally fuse."""
    from .lora import apply_lora_to_flux, extract_lora, fuse_lora

    tensors, meta = load_safetensors(path)
    rank = int(meta.get("lora_rank", 8))
    flow = pipeline.params["flow"]
    if not extract_lora(flow):
        flow = apply_lora_to_flux(flow, rank=rank)

    def walk(node, prefix=""):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                full = f"{prefix}{k}"
                if k in ("lora_a", "lora_b") and full in tensors:
                    out[k] = tensors[full].to(v.device, v.dtype)
                else:
                    out[k] = walk(v, full + ".")
            return out
        if isinstance(node, list):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        return node

    flow = walk(flow)
    if fuse:
        flow = fuse_lora(flow)
    pipeline.params["flow"] = flow
    return pipeline


def save_config(path, config: dict):
    """Sorted-JSON training config of the plain-valued entries."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    to_save = {k: config[k] for k in sorted(config) if isinstance(
        config[k], (bool, int, float, str, list, tuple, type(None))
    )}
    with open(path, "w") as f:
        json.dump(to_save, f, indent=2, sort_keys=True)


# ------------------------------------------------------------ train state


def save_train_state(ckpt_dir, step: int, lora_params, opt_state):
    """Write step, LoRA tree and optimizer state to `ckpt_dir/<step>.pt`."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    state = {"step": step, "lora": tree_map(lambda t: t.detach().cpu(), lora_params),
             "opt_state": tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t, opt_state)}
    tmp = ckpt_dir / f"{step:07d}.pt.tmp"
    torch.save(state, tmp)
    tmp.replace(ckpt_dir / f"{step:07d}.pt")


def load_train_state(ckpt_dir, lora_template, opt_template):
    """(step, LoRA tree, optimizer state) of the latest checkpoint in
    `ckpt_dir`, placed like the templates, or None where there is none."""
    ckpt_dir = Path(ckpt_dir)
    files = sorted(ckpt_dir.glob("*.pt")) if ckpt_dir.exists() else []
    if not files:
        return None
    state = torch.load(files[-1], map_location="cpu", weights_only=True)

    def place(saved, template):
        it = iter(tree_leaves(template))

        def like(s):
            t = next(it)
            return s.to(t.device, t.dtype) if torch.is_tensor(t) else s

        return tree_map(like, saved)

    return state["step"], place(state["lora"], lora_template), place(state["opt_state"], opt_template)
