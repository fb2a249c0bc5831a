"""The parameter bridge between the JAX package and the PyTorch port: param
trees built by the JAX package survive JAX → numpy → torch → numpy exactly,
and the port's modules import without loading jax."""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.clip.text import init_clip_text, tiny_clip_config
from flux_generator_tpu.models.flux.autoencoder import init_autoencoder, tiny_ae_config
from flux_generator_tpu.models.flux.model import init_flux, tiny_flux_config
from flux_generator_tpu.models.musicgen.encodec import init_encodec, tiny_encodec_config
from flux_generator_tpu.models.musicgen.model import init_musicgen, tiny_musicgen_config
from flux_generator_tpu.models.t5.t5 import init_t5, init_t5_encoder, tiny_t5_config
from flux_generator_tpu.ops.quant import quantize_tree
from flux_generator_tpu_torch.io.params import (
    num_layers, stack_layers, take_layer, to_numpy, to_torch, tree_leaves,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "flux_generator_tpu_torch"


def jax_to_torch(tree, device=None):
    """A JAX param tree → the port's torch tree (through numpy)."""
    return to_torch(jax.tree.map(np.asarray, tree), device=device)


def all_layers(p):
    return True


def _trees():
    key = jax.random.PRNGKey(0)
    k = jax.random.split(key, 4)
    flow = init_flux(k[0], tiny_flux_config())
    t5 = init_t5_encoder(k[1], tiny_t5_config())
    # jit: one compile is faster here than eager op-by-op construction
    musicgen = jax.jit(lambda key: init_musicgen(key, tiny_musicgen_config()))(k[2])
    encodec = jax.jit(lambda key: init_encodec(key, tiny_encodec_config(num_lstm_layers=2)))(k[3])
    return {
        "flow": flow,
        "flow_bf16": init_flux(k[0], tiny_flux_config(), jnp.bfloat16),
        "t5": t5,
        # encoder, decoder and lm_head (t5_generate's tree)
        "t5_full": init_t5(k[1], tiny_t5_config(tie_word_embeddings=False)),
        "clip": init_clip_text(k[2], tiny_clip_config()),
        "ae": init_autoencoder(k[3], tiny_ae_config()),
        "flow_int8": quantize_tree(flow, all_layers, bits=8),
        "flow_int8_grouped": quantize_tree(flow, all_layers, bits=8, group_size=8),
        "t5_int4_grouped": quantize_tree(t5, all_layers, bits=4, group_size=4, pack=True),
        "t5_int4_channel": quantize_tree(t5, all_layers, bits=4, pack=True),
        # EnCodec, encoder and decoder: lists of per-layer dicts (lists again
        # inside resnet/lstm)
        "encodec": encodec,
        # MusicGen: 3-D emb and linears leaves beside the stacked layers
        "musicgen": musicgen,
        "musicgen_int8_bf16": jax.jit(lambda t: quantize_tree(
            jax.tree.map(lambda a: a.astype(jnp.bfloat16), t), all_layers, bits=8))(musicgen),
    }


TREES = ["flow", "flow_bf16", "t5", "t5_full", "clip", "ae", "flow_int8", "flow_int8_grouped",
         "t5_int4_grouped", "t5_int4_channel", "encodec", "musicgen", "musicgen_int8_bf16"]


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("name", TREES)
def test_round_trip_is_exact(trees, name):
    want = jax.tree.map(np.asarray, trees[name])
    got = to_numpy(to_torch(want))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_quantized_leaves_keep_their_types(trees):
    t = jax_to_torch(trees["t5_int4_grouped"])
    q = t["encoder"]["layers"]["attention"]["q"]
    assert q["kernel_q4"].dtype == torch.uint8
    assert q["kernel_scale"].dtype == torch.float32
    assert q["kernel_scale"].ndim == 3  # (layers, groups, out)
    t8 = jax_to_torch(trees["flow_int8"])
    assert t8["double_blocks"]["img_attn"]["qkv"]["kernel_q"].dtype == torch.int8


def test_cast_touches_only_floating_leaves(trees):
    t = to_torch(jax.tree.map(np.asarray, trees["t5_int4_grouped"]), dtype=torch.bfloat16)
    assert t["wte"].dtype == torch.bfloat16
    assert t["encoder"]["layers"]["dense"]["wo"]["kernel_q4"].dtype == torch.uint8


def test_encodec_and_musicgen_trees_keep_their_layout(trees):
    enc = jax_to_torch(trees["encodec"])
    assert isinstance(enc["decoder"], list) and isinstance(enc["quantizer"], list)
    lstm_stage = next(layer for layer in enc["decoder"] if "lstm" in layer)
    assert isinstance(lstm_stage["lstm"], list) and len(lstm_stage["lstm"]) == 2
    assert lstm_stage["lstm"][0]["wh"].shape[1] == 4 * lstm_stage["lstm"][0]["wh"].shape[0]
    mg = jax_to_torch(trees["musicgen_int8_bf16"])
    assert mg["linears"].dim() == 3 and mg["emb"].dim() == 3 and mg["emb"].dtype == torch.bfloat16
    qkv = mg["layers"]["self_attn"]["qkv"]
    assert qkv["kernel_q"].dtype == torch.int8 and qkv["kernel_q"].dim() == 3
    assert qkv["kernel_scale"].dtype == torch.float32


def test_layer_helpers():
    n = 3
    stacked = stack_layers(lambda: {"a": torch.randn(2, 5), "b": {"c": torch.ones(4)}}, n)
    assert stacked["a"].shape == (n, 2, 5) and stacked["b"]["c"].shape == (n, 4)
    assert num_layers(stacked) == n
    assert take_layer(stacked, 1)["b"]["c"].shape == (4,)
    assert len(tree_leaves(stacked)) == 2


def _run(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)


# the JAX package (not the port, whose name shares its prefix) and jax itself
_LOADED = ("[m for m in sys.modules if m in ('jax', 'flux_generator_tpu') "
           "or m.startswith(('jax.', 'flux_generator_tpu.'))]")


def test_pipeline_import_does_not_load_jax():
    proc = _run("import sys, flux_generator_tpu_torch.pipelines.flux, "
                "flux_generator_tpu_torch.pipelines.musicgen, flux_generator_tpu_torch.pipelines.sd, "
                "flux_generator_tpu_torch.training.dreambooth, flux_generator_tpu_torch.server.app, "
                "flux_generator_tpu_torch.server.api, flux_generator_tpu_torch.server.memory, "
                "flux_generator_tpu_torch.io.loaders, flux_generator_tpu_torch.io.sanitize, "
                "flux_generator_tpu_torch.runtime.profiling, flux_generator_tpu_torch.utils.audio\n"
                f"loaded = {_LOADED}\n"
                "assert not loaded, loaded")
    assert proc.returncode == 0, proc.stderr


def test_tokenizers_and_a_pipeline_load_nothing_of_the_jax_package():
    """Load both tokenizers from tests/assets, build a tiny W8A8 pipeline
    (int8 flow, int8 activations through the fused route, int8 attention)
    and run a denoise step and the decode: no module of the JAX package, and no jax, is
    imported."""
    proc = _run(
        "import sys, torch\n"
        "from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer\n"
        "from flux_generator_tpu_torch.ops.quant import quantize_tree\n"
        "from flux_generator_tpu_torch.pipelines.flux import FluxPipeline\n"
        "t5 = load_t5_tokenizer('tests/assets/spiece/t5_like.model')\n"
        "clip = load_clip_tokenizer('tests/assets/clip_tokenizer/vocab.json', "
        "'tests/assets/clip_tokenizer/merges.txt')\n"
        "pipe = FluxPipeline.random_init('flux-schnell', tiny=True, device='cpu', w8a8='fused', "
        "attn_int8='full', dtype=torch.float32, hidden_size=256, num_heads=2, axes_dim=(32, 48, 48))\n"
        "pipe.params['flow'] = quantize_tree(pipe.params['flow'], lambda p: True)\n"
        "pipe.t5_tokenizer, pipe.clip_tokenizer = t5, clip\n"
        "assert pipe.tokenize('a red fox')[0].shape == (1, 256)\n"
        "from flux_generator_tpu_torch.pipelines.flux import latent_ids, pack_latents\n"
        "txt, txt_ids, vec = pipe.prepare_conditioning(1, torch.ones((1, 16), dtype=torch.long), "
        "torch.ones((1, 7), dtype=torch.long))\n"
        "x = pack_latents(torch.randn((1, 8, 8, pipe.ae_cfg.z_channels)))\n"
        "img = pipe.decode(pipe.denoise_latents(x, latent_ids(1, 8, 8), txt, txt_ids, vec, 1, 0.0), (8, 8))\n"
        "assert img.shape[::3] == (1, 3) and bool(torch.isfinite(img).all())\n"
        f"loaded = {_LOADED}\n"
        "assert not loaded, loaded\n"
    )
    assert proc.returncode == 0, proc.stderr


PROMPTS = ["a photo of a cat", "An OIL painting — of a lighthouse at dusk!", "  naïve café, 2 ümlauts ",
           "", "photo of sks dog in a bucket, 8k, ultra-detailed"]


def test_own_tokenizers_give_the_jax_ids():
    from flux_generator_tpu.tokenizers.clip_bpe import CLIPTokenizer as JaxCLIP
    from flux_generator_tpu.tokenizers.sentencepiece_unigram import (
        SentencePieceUnigramTokenizer as JaxSPM,
    )
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer

    assets = REPO / "tests" / "assets"
    for model in ("t5_like.model", "byte_fallback.model"):
        ours = load_t5_tokenizer(assets / "spiece" / model, max_length=64)
        theirs = JaxSPM.from_file(assets / "spiece" / model, max_length=64)
        assert ours.encode(PROMPTS) == theirs.encode(PROMPTS)
        assert ours.encode(PROMPTS[1], pad=False) == theirs.encode(PROMPTS[1], pad=False)
    vocab, merges = assets / "clip_tokenizer" / "vocab.json", assets / "clip_tokenizer" / "merges.txt"
    ours = load_clip_tokenizer(vocab, merges)
    theirs = JaxCLIP.from_files(vocab, merges)
    assert ours.encode(PROMPTS) == theirs.encode(PROMPTS)
    assert ours.tokenize("word " * 100) == theirs.tokenize("word " * 100)


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """With no card, the default device raises and nothing falls back to
    the CPU; a CPU device or a CPU generator still builds."""
    from flux_generator_tpu_torch.models.musicgen.encodec import EncodecModel
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
    from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
    from flux_generator_tpu_torch.runtime.device import as_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        as_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FluxPipeline.random_init("flux-schnell", tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MusicGenPipeline.random_init(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncodecModel.random_init()
    assert EncodecModel.random_init(device="cpu").params["quantizer"][0]["embed"].device.type == "cpu"
    assert FluxPipeline.random_init("flux-schnell", tiny=True, device="cpu").device.type == "cpu"
    pipe = MusicGenPipeline.random_init(tiny=True, generator=torch.Generator().manual_seed(0))
    assert pipe.device.type == "cpu"
    assert as_device("cpu") == torch.device("cpu")


def test_no_module_of_the_port_loads_jax():
    proc = _run(
        "import importlib, pkgutil, sys, flux_generator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"loaded = {_LOADED}\n"
        "assert not loaded, loaded\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_no_source_of_the_port_imports_jax():
    offenders = [
        str(path.relative_to(REPO))
        for path in PORT.rglob("*.py")
        for line in path.read_text().splitlines()
        if line.strip().startswith(("import jax", "from jax", "import flux_generator_tpu ",
                                    "import flux_generator_tpu.", "from flux_generator_tpu ",
                                    "from flux_generator_tpu."))
    ]
    assert offenders == []
