"""The port's synthetic checkpoint caches (io/synthetic.py) and safetensors
writer (io/safetensors.py), written without transformers or safetensors,
against the JAX package's io/synthetic caches, whose text-model and EnCodec
state dicts come from the transformers modules themselves: the same file
names, the same key sets, shapes and dtypes in every checkpoint, the same
config.json bodies (less the transformers_version stamp) and byte-equal
tokenizer files. The JAX loaders and the port's read a port-written cache
into equal trees (bit for bit, through the bridge). The full T5 state is
held to transformers' T5ForConditionalGeneration. The writer round-trips
bf16 bit for bit and its files read with the safetensors package."""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import load_file

from flux_generator_tpu.io import loaders as jloaders
from flux_generator_tpu.io import synthetic as jsyn
from flux_generator_tpu_torch.io import loaders, registry, synthetic
from flux_generator_tpu_torch.io.safetensors import (
    Lazy, load_safetensors, load_sharded_safetensors, nbytes, save_safetensors, save_sharded_safetensors,
)
from flux_generator_tpu_torch.models.t5.t5 import T5Config, tiny_t5_config
from tests.test_torch_loaders import _port_configs, assert_trees_equal, jax_tree, port_tree

FAMILIES = {
    "flux": (lambda r: jsyn.make_flux_cache(r), lambda r: synthetic.make_flux_cache(r, device="cpu")),
    "flux_quantizable": (lambda r: jsyn.make_flux_cache(r, quantizable=True),
                         lambda r: synthetic.make_flux_cache(r, quantizable=True, device="cpu")),
    "sd": (lambda r: jsyn.make_sd_cache(r), lambda r: synthetic.make_sd_cache(r, device="cpu")),
    "sdxl": (lambda r: jsyn.make_sd_cache(r, xl=True), lambda r: synthetic.make_sd_cache(r, xl=True, device="cpu")),
    "musicgen": (lambda r: jsyn.make_musicgen_cache(r), lambda r: synthetic.make_musicgen_cache(r, device="cpu")),
}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    made = {}

    def get(family):
        if family not in made:
            root = tmp_path_factory.mktemp(family)
            jmake, pmake = FAMILIES[family]
            made[family] = (root / "jax", jmake(root / "jax"), root / "port", pmake(root / "port"))
        return made[family]

    return get


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


def _config_body(path):
    body = json.loads(path.read_text())
    if isinstance(body, dict):
        body.pop("transformers_version", None)
    return body


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_matches_the_jax_cache(caches, family):
    jroot, _, proot, _ = caches(family)
    files = _files(jroot)
    assert _files(proot) == files
    for rel in files:
        a, b = proot / rel, jroot / rel
        if rel.endswith(".safetensors"):
            got, want = load_file(str(a)), load_file(str(b))
            assert set(got) == set(want), rel
            for k in want:
                assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), (rel, k)
                if not k.endswith("inited"):
                    assert got[k].abs().max() > 0, (rel, k)  # drawn random, never zero
        elif rel.endswith(".bin"):
            got, want = (torch.load(p, weights_only=True)["best_state"] for p in (a, b))
            assert {k: (v.shape, v.dtype) for k, v in got.items()} == {k: (v.shape, v.dtype) for k, v in want.items()}
        elif rel.endswith(".json"):
            assert _config_body(a) == _config_body(b), rel
        else:  # tokenizer files
            assert a.read_bytes() == b.read_bytes(), rel


def _loader_pair(family, proot, jconfigs):
    if family.startswith("flux"):
        want = jloaders.load_flux_pipeline("flux-schnell", dtype=jnp.float32, local_dir=str(proot), configs=jconfigs)
        got = loaders.load_flux_pipeline("flux-schnell", dtype=torch.float32, local_dir=str(proot),
                                         configs=_port_configs(jconfigs), device="cpu")
    elif family.startswith("sd"):
        name = "stabilityai/sdxl-turbo" if family == "sdxl" else "stabilityai/stable-diffusion-2-1-base"
        want = jloaders.load_sd_pipeline(name, dtype=jnp.float32, local_dir=str(proot))
        got = loaders.load_sd_pipeline(name, dtype=torch.float32, local_dir=str(proot), device="cpu")
    else:
        want = jloaders.load_musicgen_pipeline("facebook/musicgen-medium", dtype=jnp.float32, local_dir=str(proot))
        got = loaders.load_musicgen_pipeline("facebook/musicgen-medium", dtype=torch.float32,
                                             local_dir=str(proot), device="cpu")
        assert_trees_equal(port_tree(got.t5_params), jax_tree(want.t5_params))
        assert_trees_equal(port_tree(got.audio_decoder.params), jax_tree(want.audio_decoder.params))
    return got, want


@pytest.mark.parametrize("family", ["flux", "sd", "sdxl", "musicgen"])
def test_loaders_read_a_port_cache_into_equal_trees(caches, family):
    _, jconfigs, proot, _ = caches(family)
    got, want = _loader_pair(family, proot, jconfigs)
    assert_trees_equal(port_tree(got.params), jax_tree(want.params))


def _hf_t5(cfg):
    return transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff, num_layers=cfg.num_layers,
        num_decoder_layers=cfg.num_decoder_layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance,
        feed_forward_proj=cfg.feed_forward_proj, tie_word_embeddings=cfg.tie_word_embeddings, dropout_rate=0.0)


@pytest.mark.parametrize("overrides", [{}, dict(feed_forward_proj="relu", tie_word_embeddings=False,
                                                num_decoder_layers=3)], ids=["tied", "untied"])
def test_full_t5_matches_transformers(overrides):
    cfg = tiny_t5_config(**overrides)
    hf = _hf_t5(cfg)
    want = transformers.T5ForConditionalGeneration(hf).state_dict()
    got, body = synthetic.hf_t5_state(cfg, synthetic.Draw(device="cpu"), decoder=True)
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: v.shape for k, v in got.items()}
    expect = json.loads(hf.to_json_string())
    expect.pop("transformers_version")
    assert body == expect
    if cfg.tie_word_embeddings:  # tied names hold the shared embedding's values
        assert torch.equal(got["lm_head.weight"].make(), got["shared.weight"].make())
    assert torch.equal(got["decoder.embed_tokens.weight"].make(), got["shared.weight"].make())


def test_published_sizes():
    """Bytes of the full-width checkpoints, described without being made."""
    bf16 = synthetic.Draw(dtype=torch.bfloat16, device="cpu")

    def gb(state):
        return sum(nbytes(v) for v in state.values()) / 1e9

    flow, ae, clip, t5 = registry.flux_configs("flux-schnell")
    assert gb(synthetic.bfl_flux_state(flow, bf16)) == pytest.approx(23.78, abs=0.01)
    assert gb(synthetic.hf_t5_state(t5, bf16)[0]) == pytest.approx(9.79, abs=0.01)
    assert gb(synthetic.hf_clip_state(clip, bf16)[0]) == pytest.approx(0.246, abs=0.001)
    assert gb(synthetic.bfl_flux_ae_state(ae, bf16)) == pytest.approx(0.168, abs=0.001)
    unet, _, _ = registry.sd_configs("sdxl-turbo")
    assert gb(synthetic.hf_sd_unet_state(unet, bf16)) == pytest.approx(5.13, abs=0.01)


def test_writer_round_trips_bf16_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "w": torch.randn(33, 17, generator=g).to(torch.bfloat16),
        "odd": torch.randn(3, generator=g).to(torch.bfloat16),
        "f32": torch.randn(5, 2, generator=g),
        "i64": torch.arange(7),
        "u8": torch.arange(5, dtype=torch.uint8),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
        "lazy": Lazy((4, 4), torch.bfloat16, lambda: torch.full((4, 4), 1.5, dtype=torch.bfloat16)),
    }
    n = save_safetensors(tmp_path / "x.safetensors", tensors, metadata={"lora_rank": 4})
    assert n == sum(nbytes(v) for v in tensors.values())
    got = load_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        v = v.make() if isinstance(v, Lazy) else v
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(got[k].reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8))
    lib = load_file(str(tmp_path / "x.safetensors"))  # the safetensors package reads it
    assert torch.equal(lib["w"].view(torch.int16), tensors["w"].view(torch.int16))
    from safetensors import safe_open

    with safe_open(str(tmp_path / "x.safetensors"), "pt") as f:
        assert f.metadata() == {"lora_rank": "4"}
    # data offsets are aligned to each dtype's size
    header = json.loads((tmp_path / "x.safetensors").read_bytes()[8:8 + int.from_bytes(
        (tmp_path / "x.safetensors").read_bytes()[:8], "little")])
    header.pop("__metadata__")
    for info in header.values():
        size = {"BF16": 2, "F32": 4, "I64": 8, "U8": 1}[info["dtype"]]
        assert info["data_offsets"][0] % size == 0


def test_writer_shards_and_checks_descriptions(tmp_path):
    tensors = {f"t{i}": torch.full((i + 1,), float(i)) for i in range(5)}
    total = save_sharded_safetensors(tmp_path, tensors, n_shards=2)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert index["metadata"]["total_size"] == total == sum(4 * (i + 1) for i in range(5))
    assert sorted(set(index["weight_map"].values())) == ["model-00001-of-00002.safetensors",
                                                        "model-00002-of-00002.safetensors"]
    got = load_sharded_safetensors(tmp_path, "model.safetensors.index.json")
    assert all(torch.equal(got[k], v) for k, v in tensors.items())
    with pytest.raises(ValueError, match="described as"):
        save_safetensors(tmp_path / "bad.safetensors", {"x": Lazy((2,), torch.float32, lambda: torch.zeros(3))})


def test_draws_are_seeded_by_name_and_seed():
    a, b, c = synthetic.Draw(0, device="cpu"), synthetic.Draw(0, device="cpu"), synthetic.Draw(1, device="cpu")
    x = a.weight("layer.weight", 4, 4).make()
    assert torch.equal(x, b.weight("layer.weight", 4, 4).make())
    assert not torch.equal(x, c.weight("layer.weight", 4, 4).make())
    assert not torch.equal(x, a.weight("other.weight", 4, 4).make())
    assert a.weight("w", 3).make().dtype == torch.float32
    assert synthetic.Draw(0, torch.bfloat16, device="cpu").scale("s", 8).make().dtype == torch.bfloat16



def test_caches_are_drawn_on_the_card_by_default(tmp_path, monkeypatch):
    """With no device named, Draw and every make_*_cache draw on the card,
    and raise without one rather than draw on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.Draw()
    for make in (synthetic.make_flux_cache, synthetic.make_sd_cache, synthetic.make_musicgen_cache,
                 lambda r: synthetic.make_t5_cache(r, tiny_t5_config())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(tmp_path / "cache")

def test_hub_layout_resolves_through_the_loaders(tmp_path, monkeypatch):
    """hub=True writes models--org--name/refs/main and its snapshot; with
    HF_HUB_CACHE there, from_pretrained finds every repo without local_dir
    (MusicGen: its own, t5-base as a full T5, and the EnCodec repo)."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    mg_cfg, t5_cfg, _ = synthetic.make_musicgen_cache(tmp_path, device="cpu", hub=True)
    for repo in (registry.MUSICGEN_REPO, "t5-base", registry.ENCODEC_REPO):
        snap = loaders.hf_snapshot(repo)
        assert snap.parent.name == "snapshots" and (snap / "config.json").is_file()
    pipe = loaders.load_musicgen_pipeline(dtype=torch.float32, device="cpu")
    assert pipe.cfg == mg_cfg and pipe.t5_cfg == t5_cfg
    full = load_safetensors(loaders.hf_snapshot("t5-base") / "model.safetensors")
    assert "lm_head.weight" in full and "decoder.final_layer_norm.weight" in full
    flow_cfg, *_ = synthetic.make_flux_cache(tmp_path, device="cpu", hub=True)
    configs = synthetic.tiny_flux_configs(len(json.loads(
        (loaders.hf_snapshot("black-forest-labs/FLUX.1-schnell") / "tokenizer" / "vocab.json").read_text())))
    flux = loaders.load_flux_pipeline(dtype=torch.float32, device="cpu", configs=configs)
    assert flux.flow_cfg == flow_cfg
    assert dataclasses.asdict(configs[3]) == dataclasses.asdict(T5Config(**dataclasses.asdict(configs[3])))
