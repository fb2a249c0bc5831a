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
from flux_generator_tpu.models.t5.t5 import init_t5_encoder, tiny_t5_config
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
        "clip": init_clip_text(k[2], tiny_clip_config()),
        "ae": init_autoencoder(k[3], tiny_ae_config()),
        "flow_int8": quantize_tree(flow, all_layers, bits=8),
        "flow_int8_grouped": quantize_tree(flow, all_layers, bits=8, group_size=8),
        "t5_int4_grouped": quantize_tree(t5, all_layers, bits=4, group_size=4, pack=True),
        "t5_int4_channel": quantize_tree(t5, all_layers, bits=4, pack=True),
        # EnCodec: lists of per-layer dicts (lists again inside resnet/lstm)
        "encodec": encodec,
        # MusicGen: 3-D emb and linears leaves beside the stacked layers
        "musicgen": musicgen,
        "musicgen_int8_bf16": jax.jit(lambda t: quantize_tree(
            jax.tree.map(lambda a: a.astype(jnp.bfloat16), t), all_layers, bits=8))(musicgen),
    }


TREES = ["flow", "flow_bf16", "t5", "clip", "ae", "flow_int8", "flow_int8_grouped",
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


def test_pipeline_import_does_not_load_jax():
    proc = _run("import sys, flux_generator_tpu_torch.pipelines.flux, "
                "flux_generator_tpu_torch.pipelines.musicgen; "
                "assert 'jax' not in sys.modules, 'jax loaded'")
    assert proc.returncode == 0, proc.stderr


def test_no_module_of_the_port_loads_jax():
    proc = _run(
        "import importlib, pkgutil, sys, flux_generator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_no_source_of_the_port_imports_jax():
    offenders = [
        str(path.relative_to(REPO))
        for path in PORT.rglob("*.py")
        for line in path.read_text().splitlines()
        if line.strip().startswith(("import jax", "from jax"))
    ]
    assert offenders == []
