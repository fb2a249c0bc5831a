"""The port's T5 decoder (models/t5/t5.py: init_t5, init_decode_cache,
t5_decode in its full causal and cached forms) and the t5_generate CLI's
greedy decoding and full-T5 load, held against the JAX package on the CPU at
a tiny config: the same params (JAX init, bridged) and the same seeded
numpy tokens. f32 throughout; logits and caches within 1e-5 (absolute, on
logits of order 1); greedy tokens and decoded text equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.cli import t5_generate as jcli
from flux_generator_tpu.io import sanitize as jsan
from flux_generator_tpu.io.loaders import cast_tree as jcast_tree
from flux_generator_tpu.io.loaders import conform_params as jconform
from flux_generator_tpu.io.params import unflatten as junflatten
from flux_generator_tpu.models.t5 import t5 as jt5
from flux_generator_tpu.tokenizers.sentencepiece_unigram import (
    SentencePieceUnigramTokenizer as JTokenizer,
)
from flux_generator_tpu_torch.cli import t5_generate
from flux_generator_tpu_torch.io import synthetic
from flux_generator_tpu_torch.io.params import to_numpy
from flux_generator_tpu_torch.models.t5 import t5
from flux_generator_tpu_torch.tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer
from tests.test_torch_bridge import jax_to_torch

TOL = 1e-5


def _configs(**overrides):
    base = dict(num_decoder_layers=3)
    base.update(overrides)
    jcfg = jt5.tiny_t5_config(**base)
    return jcfg, t5.T5Config(**dataclasses.asdict(jcfg))


CASES = {
    "tied_gated": {},
    "untied_relu": dict(tie_word_embeddings=False, feed_forward_proj="relu"),
}


@functools.lru_cache(maxsize=None)
def _model(case):
    jcfg, cfg = _configs(**CASES[case])
    jp = jax.jit(lambda k: jt5.init_t5(k, jcfg))(jax.random.PRNGKey(3))
    return jcfg, cfg, jp, jax_to_torch(jp)


def _inputs(cfg, b=2, s=5, t=6, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(2, cfg.vocab_size, (b, s)).astype(np.int32)
    tgt = rng.randint(2, cfg.vocab_size, (b, t)).astype(np.int32)
    return src, tgt


@pytest.mark.parametrize("case", list(CASES))
def test_init_t5_tree_matches_jax(case):
    jcfg, cfg, jp, _ = _model(case)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.tree.map(np.asarray, jp))
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       to_numpy(t5.init_t5(torch.Generator().manual_seed(0), cfg)))
    assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_full_decode_matches_jax(case):
    jcfg, cfg, jp, tp = _model(case)
    src, tgt = _inputs(cfg)
    jmem = jax.jit(lambda p, x: jt5.t5_encode(p, jcfg, x))(jp, src)
    jlogits, jcache = jax.jit(lambda p, x, m: jt5.t5_decode(p, jcfg, x, m))(jp, tgt, jmem)
    assert jcache is None
    logits, cache = t5.t5_decode(tp, cfg, torch.from_numpy(tgt).long(), torch.from_numpy(np.asarray(jmem)))
    assert cache is None and logits.shape == (2, 6, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_cached_decode_matches_jax_and_the_full_form(case):
    """Chunks of 3, 2 and 1 tokens into an 8-position cache: each chunk's
    logits and the cache after it equal JAX's; every position's logits equal
    the full causal decode's."""
    jcfg, cfg, jp, tp = _model(case)
    src, tgt = _inputs(cfg)
    jmem = np.asarray(jax.jit(lambda p, x: jt5.t5_encode(p, jcfg, x))(jp, src))
    mem = torch.from_numpy(jmem)
    jstep = jax.jit(lambda p, x, m, c: jt5.t5_decode(p, jcfg, x, m, c))
    jcache = jt5.init_decode_cache(jcfg, 2, 8)
    cache = t5.init_decode_cache(cfg, 2, 8)
    full, _ = t5.t5_decode(tp, cfg, torch.from_numpy(tgt).long(), mem)
    at = 0
    for n in (3, 2, 1):
        chunk = tgt[:, at:at + n]
        jlogits, jcache = jstep(jp, chunk, jmem, jcache)
        logits, cache = t5.t5_decode(tp, cfg, torch.from_numpy(chunk).long(), mem, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=0)
        np.testing.assert_allclose(logits.numpy(), full[:, at:at + n].numpy(), atol=TOL, rtol=0)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), atol=TOL, rtol=0)
        assert cache["offset"] == int(jcache["offset"]) == at + n
        at += n
    with pytest.raises(ValueError, match="holds 8 positions"):
        t5.t5_decode(tp, cfg, torch.from_numpy(tgt[:, :3]).long(), mem, cache)


@pytest.fixture(scope="module")
def spiece(tmp_path_factory):
    path = tmp_path_factory.mktemp("spiece") / "spiece.model"
    synthetic.write_spiece(path)
    return path


@pytest.mark.parametrize("case", list(CASES))
def test_generate_greedy_matches_jax(case, spiece, monkeypatch):
    # the JAX CLI calls these eagerly; jitted here, with the config static
    monkeypatch.setattr(jt5, "t5_decode", jax.jit(jt5.t5_decode, static_argnums=1))
    monkeypatch.setattr(jt5, "t5_encode", jax.jit(jt5.t5_encode, static_argnums=1))
    tok = SentencePieceUnigramTokenizer.from_file(spiece)
    jtok = JTokenizer.from_file(spiece)
    jcfg, cfg = _configs(vocab_size=len(tok.id_to_piece), **CASES[case])
    jp = jax.jit(lambda k: jt5.init_t5(k, jcfg))(jax.random.PRNGKey(5))
    # a scale that spreads the logits, so that the greedy path is not EOS at once
    jp = jax.tree.map(lambda a: a * 8.0, jp)
    tp = jax_to_torch(jp)
    want = jcli.generate_greedy(jp, jcfg, jtok, "a photo of a cat", max_tokens=12)
    ids = t5_generate.greedy_tokens(tp, cfg, tok, "a photo of a cat", max_tokens=12)
    assert t5_generate.generate_greedy(tp, cfg, tok, "a photo of a cat", max_tokens=12) == want
    assert tok.decode(ids) == want and len(ids) > 0


def test_load_matches_the_jax_cli_load(tmp_path, spiece):
    """A port-written full T5 repo read by the CLI's load and by the JAX
    CLI's load steps (sanitize, unflatten, conform to init_t5, f32): equal
    trees, and the tokenizer from the repo's spiece.model."""
    jcfg, cfg = _configs(tie_word_embeddings=False)
    base = synthetic.make_t5_cache(tmp_path, cfg, device="cpu")
    model = t5_generate.load("org/t5-tiny", device="cpu", local_dir=base)
    from safetensors.numpy import load_file

    flat = jsan.sanitize_t5(load_file(str(base / "model.safetensors")))
    want = jconform(junflatten(flat, jsan.T5_STACKS),
                    jax.eval_shape(lambda: jt5.init_t5(jax.random.PRNGKey(0), jcfg)), "t5")
    want = jcast_tree(want, jnp.float32)
    got, ref = to_numpy(model.params), to_numpy(jax_to_torch(want))
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert model.cfg == cfg
    assert model.tokenizer.tokenize("a cat") == JTokenizer.from_file(spiece).tokenize("a cat")
