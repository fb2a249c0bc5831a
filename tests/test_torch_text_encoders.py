"""T5 encoder and CLIP text encoder of the port against the JAX package's at
tiny config (CPU, f32). atol 1e-5 for the float paths; 1e-4 for int4, whose
dequantized weights enter two half-products instead of one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.clip import text as jclip
from flux_generator_tpu.models.t5 import t5 as jt5
from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
from flux_generator_tpu_torch.models.clip import text as tclip
from flux_generator_tpu_torch.models.t5 import t5 as tt5
from tests.test_torch_bridge import all_layers, jax_to_torch


def _tokens(seed, b, n, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, n)).astype(np.int32)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("lq,lk", [(12, 12), (256, 256), (3, 40)])
def test_relative_bias_matches_jax(bidirectional, lq, lk):
    cfg_j = jt5.tiny_t5_config(relative_attention_num_buckets=32, relative_attention_max_distance=128)
    cfg_t = tt5.tiny_t5_config(relative_attention_num_buckets=32, relative_attention_max_distance=128)
    emb = np.random.default_rng(1).standard_normal((32, 2)).astype(np.float32)
    want = jt5.relative_bias(jnp.asarray(emb), cfg_j, lq, lk, bidirectional=bidirectional)
    got = tt5.relative_bias(torch.from_numpy(emb), cfg_t, lq, lk, bidirectional=bidirectional)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [None, "int4_g4", "int4_channel"])
def test_t5_encode_matches_jax(quant):
    cfg_j, cfg_t = jt5.tiny_t5_config(), tt5.tiny_t5_config()
    params = jt5.init_t5_encoder(jax.random.PRNGKey(2), cfg_j)
    if quant == "int4_g4":
        params = jax_quantize_tree(params, all_layers, bits=4, group_size=4, pack=True)
    elif quant == "int4_channel":
        params = jax_quantize_tree(params, all_layers, bits=4, pack=True)
    toks = _tokens(3, 2, 11, cfg_j.vocab_size)
    want = jt5.t5_encode(params, cfg_j, jnp.asarray(toks))
    got = tt5.t5_encode(jax_to_torch(params), cfg_t, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4 if quant else 1e-5)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_matches_jax(act):
    cfg_j = jclip.tiny_clip_config(hidden_act=act)
    cfg_t = tclip.tiny_clip_config(hidden_act=act)
    params = jclip.init_clip_text(jax.random.PRNGKey(4), cfg_j)
    toks = _tokens(5, 2, 9, cfg_j.vocab_size - 1)
    toks[0, 6] = cfg_j.vocab_size - 1  # EOS (the largest id) mid-row: pooled there
    toks[1, -1] = cfg_j.vocab_size - 1
    want = jclip.clip_text_forward(params, cfg_j, jnp.asarray(toks))
    got = tclip.clip_text_forward(jax_to_torch(params), cfg_t, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got["pooled_output"].numpy(), np.asarray(want["pooled_output"]), atol=1e-5)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               np.asarray(want["last_hidden_state"]), atol=1e-5)


def test_clip_text_projection_matches_jax():
    cfg_j = jclip.tiny_clip_config(projection_dim=12)
    cfg_t = tclip.tiny_clip_config(projection_dim=12)
    params = jclip.init_clip_text(jax.random.PRNGKey(6), cfg_j)
    toks = _tokens(7, 1, 6, cfg_j.vocab_size)
    want = jclip.clip_text_forward(params, cfg_j, jnp.asarray(toks))["pooled_output"]
    got = tclip.clip_text_forward(jax_to_torch(params), cfg_t, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got["pooled_output"].numpy(), np.asarray(want), atol=1e-5)
