"""The port's checkpoint path on the CPU (io/safetensors.py, io/sanitize.py,
io/params.py, io/loaders.py) against the JAX package's, on the synthetic
caches that flux_generator_tpu.io.synthetic writes in the real on-disk
formats: the trees the port's loaders build are equal, leaf for leaf and bit
for bit, to the JAX loaders' (f32 exactly, quantized leaves equal), and the
key mappers' outputs to the JAX mappers' on the same state dicts. Also the
safetensors reader (BF16 bit for bit, truncated files), the local Hugging
Face hub cache resolution and load-time shape errors. The SD, SDXL and
MusicGen loaders are in test_torch_loaders_sd_musicgen.py."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.io import loaders as jloaders
from flux_generator_tpu.io import sanitize as jsan
from flux_generator_tpu.io import synthetic
from flux_generator_tpu.io.params import unflatten as junflatten
from flux_generator_tpu.models.musicgen.encodec import decoder_spec, encoder_spec, tiny_encodec_config
from flux_generator_tpu.models.musicgen.model import tiny_musicgen_config
from flux_generator_tpu.models.sd.config import tiny_sd_ae_config, tiny_unet_config
from flux_generator_tpu.models.t5.t5 import tiny_t5_config
from flux_generator_tpu_torch.io import loaders, sanitize
from flux_generator_tpu_torch.io.params import to_numpy, unflatten
from flux_generator_tpu_torch.io.safetensors import load_safetensors, load_sharded_safetensors
from flux_generator_tpu_torch.models.clip.text import CLIPTextConfig
from flux_generator_tpu_torch.models.flux.autoencoder import AutoEncoderConfig
from flux_generator_tpu_torch.models.flux.model import FluxConfig
from flux_generator_tpu_torch.models.t5.t5 import T5Config
from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
from tests.test_torch_bridge import jax_to_torch


def assert_trees_equal(got, want, path=""):
    """Same structure, shapes, dtypes and bits (bf16 by its bytes)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{path}/{i}")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (path, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.uint16), b.view(np.uint16)
        np.testing.assert_array_equal(a, b, err_msg=path)


def port_tree(tree):
    return to_numpy(tree)


def jax_tree(tree):
    return to_numpy(jax_to_torch(tree))


def _port_configs(configs):
    return tuple(cls(**dataclasses.asdict(c)) for cls, c in
                 zip((FluxConfig, AutoEncoderConfig, CLIPTextConfig, T5Config), configs))


@pytest.fixture(scope="module")
def flux_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("flux_cache")
    return root, synthetic.make_flux_cache(root)


@pytest.fixture(scope="module")
def flux_cache_q(tmp_path_factory):
    """The flow at hidden 512, so the int8 predicate (in % 512 == 0) fires."""
    root = tmp_path_factory.mktemp("flux_cache_q")
    return root, synthetic.make_flux_cache(root, quantizable=True)


# ------------------------------------------------------------ the loaders


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flux_loader_matches_jax(flux_cache, dtype):
    root, configs = flux_cache
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    pj = jloaders.load_flux_pipeline("flux-schnell", dtype=jd, local_dir=str(root), configs=configs)
    pt = loaders.load_flux_pipeline("flux-schnell", dtype=td, local_dir=str(root), configs=_port_configs(configs),
                                    device="cpu")
    assert isinstance(pt, FluxPipeline) and pt.dtype == td
    assert_trees_equal(port_tree(pt.params), jax_tree(pj.params))
    # the tokenizers came from the cache's asset files
    assert pt.clip_tokenizer.vocab_size == pj.clip_tokenizer.vocab_size == configs[2].vocab_size
    assert pt.clip_tokenizer.encode("a photo of a cat") == pj.clip_tokenizer.encode("a photo of a cat")
    assert pt.t5_tokenizer.encode("a photo of a cat") == pj.t5_tokenizer.encode("a photo of a cat")


@pytest.mark.parametrize("quantize", [True, "int4"])
def test_flux_quantized_load_matches_jax(flux_cache_q, quantize):
    """int8: flow and T5 int8 per channel; int4: the flow int4 in groups of
    128, packed, T5 int8. Quantized leaves equal; int8 stored K-contiguous."""
    root, configs = flux_cache_q
    pj = jloaders.load_flux_pipeline("flux-schnell", dtype=jnp.bfloat16, local_dir=str(root), configs=configs,
                                     quantize=quantize)
    pt = loaders.load_flux_pipeline("flux-schnell", dtype=torch.bfloat16, local_dir=str(root),
                                    configs=_port_configs(configs), quantize=quantize, device="cpu")
    assert_trees_equal(port_tree(pt.params), jax_tree(pj.params))
    qkv = pt.params["flow"]["double_blocks"]["img_attn"]["qkv"]
    if quantize == "int4":
        assert qkv["kernel_q4"].dtype == torch.uint8
    else:
        assert qkv["kernel_q"].dtype == torch.int8 and qkv["kernel_q"].stride(-2) == 1


def test_flux_sharded_t5_index_is_read(flux_cache):
    root, _ = flux_cache
    index = json.loads((root / "text_encoder_2" / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) == 2
    sharded = load_sharded_safetensors(root / "text_encoder_2", "model.safetensors.index.json")
    assert set(sharded) == set(index["weight_map"])


def test_flux_wrong_shape_fails_at_load_with_its_path(flux_cache, tmp_path):
    root, configs = flux_cache
    bad = tmp_path / "bad"
    shutil.copytree(root, bad)
    state = synthetic.bfl_flux_state(configs[0])
    state["img_in.weight"] = state["img_in.weight"][:, :-1]
    synthetic.save_safetensors(bad / "flux1-schnell.safetensors", state)
    with pytest.raises(ValueError, match="shape mismatch at flux-flow/img_in/kernel"):
        loaders.load_flux_pipeline("flux-schnell", dtype=torch.float32, local_dir=str(bad),
                                   configs=_port_configs(configs), device="cpu")
    state.pop("img_in.weight")
    synthetic.save_safetensors(bad / "flux1-schnell.safetensors", state)
    with pytest.raises(ValueError, match="missing param flux-flow/img_in/kernel"):
        loaders.load_flux_pipeline("flux-schnell", dtype=torch.float32, local_dir=str(bad),
                                   configs=_port_configs(configs), device="cpu")


def test_truncated_file_names_its_path_and_tensor(flux_cache, tmp_path):
    root, _ = flux_cache
    src = root / "ae.safetensors"
    cut = tmp_path / "ae.safetensors"
    cut.write_bytes(src.read_bytes()[:-1])
    with pytest.raises(ValueError, match=f"{cut}.*truncated"):
        load_safetensors(cut)


def test_env_overrides_name_the_flux_files(flux_cache, tmp_path, monkeypatch):
    """FLUX_SCHNELL and AE name the flow and autoencoder files in place of
    the directory's."""
    root, configs = flux_cache
    alt = tmp_path / "alt"
    shutil.copytree(root, alt)
    moved = tmp_path / "elsewhere"
    moved.mkdir()
    shutil.move(alt / "flux1-schnell.safetensors", moved / "flow.safetensors")
    shutil.move(alt / "ae.safetensors", moved / "vae.safetensors")
    monkeypatch.setenv("FLUX_SCHNELL", str(moved / "flow.safetensors"))
    monkeypatch.setenv("AE", str(moved / "vae.safetensors"))
    pt = loaders.load_flux_pipeline("flux-schnell", dtype=torch.float32, local_dir=str(alt),
                                    configs=_port_configs(configs), device="cpu")
    pj = jloaders.load_flux_pipeline("flux-schnell", dtype=jnp.float32, local_dir=str(root), configs=configs)
    assert_trees_equal(port_tree(pt.params), jax_tree(pj.params))


def _hub_repo(hub, repo_id, commit="0123abcd"):
    repo = hub / f"models--{repo_id.replace('/', '--')}"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(commit + "\n")
    snap = repo / "snapshots" / commit
    snap.mkdir(parents=True)
    return snap


def test_hub_cache_resolution(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    snap = _hub_repo(tmp_path / "home" / "hub", "org/model")
    (snap / "file.json").write_text("{}")
    assert loaders.hf_snapshot("org/model") == snap
    assert loaders.hf_download("org/model", "file.json") == snap / "file.json"
    assert loaders.hf_snapshot("org/model", revision="0123abcd") == snap
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "cache"))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "cache" / "models--org--model")):
        loaders.hf_snapshot("org/model")
    snap2 = _hub_repo(tmp_path / "cache", "org/model", "feed")
    with pytest.raises(FileNotFoundError, match=str(snap2 / "missing.bin")):
        loaders.hf_download("org/model", "missing.bin")
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.delenv("HF_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "user"))
    assert loaders.hub_cache_dir() == tmp_path / "user" / ".cache" / "huggingface" / "hub"


def test_flux_loads_from_the_hub_cache(flux_cache, tmp_path, monkeypatch):
    """Without local_dir, the registry's repo id resolves in the hub cache."""
    root, configs = flux_cache
    snap = _hub_repo(tmp_path, "black-forest-labs/FLUX.1-schnell")
    shutil.copytree(root, snap, dirs_exist_ok=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    pt = FluxPipeline.from_pretrained("flux-schnell", dtype=torch.float32, configs=_port_configs(configs),
                                      device="cpu")
    pj = jloaders.load_flux_pipeline("flux-schnell", dtype=jnp.float32, local_dir=str(root), configs=configs)
    assert_trees_equal(port_tree(pt.params), jax_tree(pj.params))


def test_from_pretrained_needs_a_card_by_default(flux_cache, monkeypatch):
    root, configs = flux_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FluxPipeline.from_pretrained("flux-schnell", local_dir=str(root), configs=_port_configs(configs))


# ------------------------------------------------------------ the safetensors reader


def test_bf16_and_every_dtype_read_bit_for_bit(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(7, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(3, generator=g).half(), "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-128, 127, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 255, (3, 3), generator=g, dtype=torch.uint8),
        "i64": torch.arange(5, dtype=torch.int64), "odd_u8": torch.arange(3, dtype=torch.uint8),
        "empty": torch.zeros(0, 4), "scalar_f32": torch.tensor(1.5),
    }
    save_file(tensors, str(tmp_path / "x.safetensors"))
    got = load_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k].reshape(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8)), k


def test_bf16_checkpoint_stays_bf16_through_the_mappers(tmp_path):
    """A BF16 flux file keeps its bits from the file to the tree (real Flux
    and SDXL checkpoints are BF16; numpy has no bf16)."""
    from safetensors.torch import save_file

    from flux_generator_tpu.models.flux.model import tiny_flux_config

    state = {k: torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
             for k, v in synthetic.bfl_flux_state(tiny_flux_config()).items()}
    save_file(state, str(tmp_path / "flow.safetensors"))
    flat = sanitize.sanitize_flux(load_safetensors(tmp_path / "flow.safetensors"))
    assert {v.dtype for v in flat.values()} == {torch.bfloat16}
    assert torch.equal(flat["img_in.kernel"], state["img_in.weight"].t())


# ------------------------------------------------------------ the key mappers (against JAX's)


def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _mapped(fn_j, fn_t, state, *args):
    state = _np_state(state)
    want = fn_j(dict(state), *args)
    got = fn_t({k: torch.from_numpy(v.copy()) for k, v in state.items()}, *args)
    assert set(got) == set(want)
    for k in want:
        assert_trees_equal(got[k].numpy(), np.asarray(want[k]), k)
    return got, want


def _states():
    from flux_generator_tpu.models.clip.text import tiny_clip_config
    from flux_generator_tpu.models.flux.autoencoder import tiny_ae_config
    from flux_generator_tpu.models.flux.model import tiny_flux_config

    clip = tiny_clip_config()
    enc = tiny_encodec_config(num_lstm_layers=2)
    return {
        "flux": (jsan.sanitize_flux, sanitize.sanitize_flux, synthetic.bfl_flux_state(tiny_flux_config()), ()),
        "flux_ae": (jsan.sanitize_flux_ae, sanitize.sanitize_flux_ae, synthetic.bfl_flux_ae_state(tiny_ae_config()),
                    ()),
        "clip": (jsan.sanitize_clip, sanitize.sanitize_clip,
                 synthetic.hf_clip_state(2, clip.model_dims, clip.num_heads, clip.max_length, clip.vocab_size,
                                         projection_dim=clip.model_dims)[0], ()),
        "t5": (jsan.sanitize_t5, sanitize.sanitize_t5, synthetic.hf_t5_encoder_state(tiny_t5_config())[0], ()),
        "sd_unet": (jsan.sanitize_sd_unet, sanitize.sanitize_sd_unet,
                    synthetic.hf_sd_unet_state(tiny_unet_config()), ()),
        "sdxl_unet": (jsan.sanitize_sd_unet, sanitize.sanitize_sd_unet, synthetic.hf_sd_unet_state(tiny_unet_config(
            addition_embed_type="text_time", addition_time_embed_dim=8, projection_class_embeddings_input_dim=56,
            cross_attention_dim=(16, 16))), ()),
        "sd_vae": (jsan.sanitize_sd_vae, sanitize.sanitize_sd_vae, synthetic.hf_sd_vae_state(tiny_sd_ae_config()),
                   ()),
        "musicgen": (jsan.sanitize_musicgen, sanitize.sanitize_musicgen,
                     synthetic.audiocraft_musicgen_state(tiny_musicgen_config()), ()),
        "encodec": (jsan.sanitize_encodec, sanitize.sanitize_encodec, synthetic.hf_encodec_state(enc)[0],
                    (encoder_spec(enc), decoder_spec(enc))),
    }


@pytest.fixture(scope="module")
def states():
    return _states()


@pytest.mark.parametrize("name", ["flux", "flux_ae", "clip", "t5", "sd_unet", "sdxl_unet", "sd_vae", "musicgen",
                                  "encodec"])
def test_mapper_matches_jax(states, name):
    """Equal keys and equal tensors, bit for bit (EnCodec's weight-norm
    fusion included: it sums in numpy, as the JAX package does)."""
    fn_j, fn_t, state, args = states[name]
    _mapped(fn_j, fn_t, state, *args)


def test_sd_unet_geglu_split_and_stacking(states):
    """The GEGLU projection splits into linear1 (value) and linear2 (gate),
    and the assembled trees (stacked transformer blocks) match JAX's."""
    fn_j, fn_t, state, _ = states["sd_unet"]
    got, want = _mapped(fn_j, fn_t, state)
    assert any(".linear2.kernel" in k for k in got)
    stacks = ("down_blocks.attentions.blocks", "up_blocks.attentions.blocks", "mid_blocks.blocks")
    assert_trees_equal(port_tree(unflatten(got, stacks)), jax.tree.map(np.asarray, junflatten(want, stacks)))


def test_fuse_weight_norm_matches_jax():
    rng = np.random.default_rng(0)
    state = {"a.weight_g": rng.standard_normal((4, 1, 1)).astype(np.float32),
             "a.weight_v": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "b.parametrizations.weight.original0": rng.standard_normal((2, 1, 1)).astype(np.float32),
             "b.parametrizations.weight.original1": rng.standard_normal((2, 6, 3)).astype(np.float32),
             "c.bias": rng.standard_normal(3).astype(np.float32)}
    want = jsan.fuse_weight_norm(dict(state))
    got = sanitize.fuse_weight_norm({k: torch.from_numpy(v) for k, v in state.items()})
    assert set(got) == set(want) == {"a.weight", "b.weight", "c.bias"}
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_transforms_match_jax():
    from flux_generator_tpu.io import params as jparams
    from flux_generator_tpu_torch.io import params as tparams

    rng = np.random.default_rng(1)
    for name, shape in (("t_linear", (3, 5)), ("t_conv2d", (4, 3, 3, 2)), ("t_conv1d", (4, 3, 5)),
                        ("t_convtr1d", (4, 3, 5))):
        w = rng.standard_normal(shape).astype(np.float32)
        got = getattr(tparams, name)(torch.from_numpy(w))
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), getattr(jparams, name)(w))


def test_unflatten_matches_jax():
    rng = np.random.default_rng(2)
    flat = {f"layers.{i}.{n}.kernel": rng.standard_normal((2, 3)).astype(np.float32)
            for i in range(3) for n in ("q", "k")}
    flat.update({"enc.0.w": np.ones(2, np.float32), "enc.2.w": np.zeros(2, np.float32), "top": np.ones(1, np.float32)})
    want = junflatten(flat, ("layers",))
    got = unflatten({k: torch.from_numpy(v) for k, v in flat.items()}, ("layers",))
    assert got["enc"][1] == {}  # an index gap (EnCodec's ELU slots)
    assert_trees_equal(port_tree(got), jax.tree.map(np.asarray, want))
