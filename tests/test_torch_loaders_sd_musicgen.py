"""The port's SD, SDXL and MusicGen loaders (io/loaders.py) against the JAX
package's on the synthetic caches of flux_generator_tpu.io.synthetic, in the
real on-disk formats (diffusers config.json files and safetensors; torch
state_dict.bin for MusicGen, with its T5 and EnCodec directories): equal
trees leaf for leaf and bit for bit (f32 exactly, quantized leaves equal),
the same configs (Hugging Face's up_block_types reversed into levels), the
same tokenizers, and the pipeline classes that random_init builds. CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.io import loaders as jloaders
from flux_generator_tpu.io import synthetic
from flux_generator_tpu_torch.io import loaders
from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL
from tests.test_torch_loaders import assert_trees_equal, jax_tree, port_tree


@pytest.fixture(scope="module")
def sd_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd_cache")
    synthetic.make_sd_cache(root)
    return root


@pytest.fixture(scope="module")
def sdxl_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("sdxl_cache")
    synthetic.make_sd_cache(root, xl=True)
    return root


@pytest.fixture(scope="module")
def musicgen_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("musicgen_cache")
    synthetic.make_musicgen_cache(root)
    return root


def _sd_pair(root, name, quantize, xl):
    pj = jloaders.load_sd_pipeline(name, dtype=jnp.float32, local_dir=str(root), quantize=quantize)
    pt = loaders.load_sd_pipeline(name, dtype=torch.float32, local_dir=str(root), quantize=quantize, device="cpu")
    assert type(pt) is (StableDiffusionXL if xl else StableDiffusion)
    assert_trees_equal(port_tree(pt.params), jax_tree(pj.params))
    assert dataclasses.asdict(pt.unet_cfg) == dataclasses.asdict(pj.unet_cfg)
    assert dataclasses.asdict(pt.ae_cfg) == dataclasses.asdict(pj.ae_cfg)
    assert [dataclasses.asdict(c) for c in pt.clip_cfgs] == [dataclasses.asdict(c) for c in pj.clip_cfgs]
    assert dataclasses.asdict(pt.diffusion_cfg) == dataclasses.asdict(pj.diffusion_cfg)
    for tt, tj in zip(pt.tokenizers, pj.tokenizers):
        assert tt.tokenize("a photo of a cat") == tj.tokenize("a photo of a cat")
    return pt, pj


@pytest.mark.parametrize("quantize", [False, True])
def test_sd_loader_matches_jax(sd_cache, quantize):
    import json

    pt, _ = _sd_pair(sd_cache, "stable-diffusion-2-1-base", quantize, xl=False)
    # the file lists up blocks deepest first, as Hugging Face's do; the config is by level
    listed = json.loads((sd_cache / "unet" / "config.json").read_text())["up_block_types"]
    assert pt.unet_cfg.up_block_types == tuple(listed[::-1]) != tuple(listed)


@pytest.mark.parametrize("quantize", [False, True])
def test_sdxl_loader_matches_jax(sdxl_cache, quantize):
    pt, _ = _sd_pair(sdxl_cache, "sdxl-turbo-synthetic-xl", quantize, xl=True)
    assert "clip_2" in pt.params and len(pt.tokenizers) == 2


def test_sd_int8_policy_is_the_predicates(sd_cache, monkeypatch):
    """With a predicate that accepts the tiny UNet's and CLIP's denses, the
    quantized load puts exactly those in int8 per channel (K-contiguous), the
    convs and the VAE in the working dtype, as the JAX loader does."""
    from flux_generator_tpu.io import loaders as jl

    def every_dense(p):
        return p["kernel"].ndim <= 3

    monkeypatch.setattr(jl, "_sd_quant_predicate", every_dense)
    monkeypatch.setattr(loaders, "_sd_quant_predicate", every_dense)
    pt, _ = _sd_pair(sd_cache, "stable-diffusion-2-1-base", True, xl=False)
    q = pt.params["unet"]["down_blocks"][0]["attentions"][0]["proj_in"]["kernel_q"]
    assert q.dtype == torch.int8 and q.stride(-2) == 1
    assert "kernel" in pt.params["unet"]["conv_in"] and "kernel_q" not in str(pt.params["vae"])
    assert "kernel_q" in pt.params["clip"]["layers"]["q"]


@pytest.mark.parametrize("quantize", [False, True])
def test_musicgen_loader_matches_jax(musicgen_cache, quantize):
    pj = jloaders.load_musicgen_pipeline(dtype=jnp.float32, local_dir=str(musicgen_cache), quantize=quantize)
    pt = loaders.load_musicgen_pipeline(dtype=torch.float32, local_dir=str(musicgen_cache), quantize=quantize,
                                        device="cpu")
    assert isinstance(pt, MusicGenPipeline)
    assert_trees_equal(port_tree(pt.params), jax_tree(pj.params))
    assert_trees_equal(port_tree(pt.t5_params), jax_tree(pj.t5_params))
    # EnCodec stays f32, its encoder branch loaded and conformed too
    assert_trees_equal(port_tree(pt.audio_decoder.params), jax_tree(pj.audio_decoder.params))
    assert {v.dtype for v in jax.tree_util.tree_leaves(port_tree(pt.audio_decoder.params))} == {np.dtype("float32")}
    assert "encoder" in pt.audio_decoder.params
    assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(pj.cfg)
    assert dataclasses.asdict(pt.t5_cfg) == dataclasses.asdict(pj.t5_cfg)
    assert pt.tokenizer.encode("happy rock", pad=False) == pj.tokenizer.encode("happy rock", pad=False)


def test_musicgen_from_pretrained_generates(musicgen_cache):
    pipe = MusicGenPipeline.from_pretrained(local_dir=str(musicgen_cache), dtype=torch.float32, device="cpu",
                                            w8a8="ops")
    assert pipe.w8a8 == "ops"
    audio = pipe.generate("piano music", max_steps=8, top_k=4, seed=1)
    assert audio.ndim == 2 and bool(torch.isfinite(audio).all())


def test_sd_from_pretrained_generates(sdxl_cache):
    pipe = StableDiffusionXL.from_pretrained("sdxl-turbo-synthetic-xl", local_dir=str(sdxl_cache),
                                             dtype=torch.float32, device="cpu", attn_int8="qk")
    assert isinstance(pipe, StableDiffusionXL) and pipe.attn_int8 == "qk"
    lat = list(pipe.generate_latents("a cat", num_steps=1, cfg_weight=0.0, latent_size=(8, 8), seed=3))[-1]
    assert bool(torch.isfinite(pipe.decode(lat)).all())

