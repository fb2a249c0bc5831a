"""The MusicGen decoder: the port against the JAX package at tiny size in f32
— sinusoidal positions, the param tree, cross-attention K/V, the plain layer
loop `decode_step` (bf16/f32 and int8 weights, several steps into the cache,
cond_len masks), top-k sampling at top_k = 1, the route `generate` takes,
and `generate` itself with per-sample cond_len and live_steps.

Tolerances: f32 on both sides with the same op order up to XLA's and
torch's summation orders — atol 1e-5 on activations and logits; the
positions at offset 499 differ by the two libraries' cos/sin of a large
argument (3e-5 measured): atol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.musicgen import model as jmg
from flux_generator_tpu.ops.embeddings import sinusoidal_positions as jax_positions
from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
from flux_generator_tpu_torch.io.params import to_torch
from flux_generator_tpu_torch.models.musicgen import model as tmg
from flux_generator_tpu_torch.ops.embeddings import sinusoidal_positions

ATOL = 1e-5


def _port(jcfg, jparams):
    return tmg.MusicGenConfig(**dataclasses.asdict(jcfg)), to_torch(jax.tree.map(np.asarray, jparams))


def _setup(quantize=False, **overrides):
    jcfg = jmg.tiny_musicgen_config(**overrides)
    jp = jmg.init_musicgen(jax.random.PRNGKey(0), jcfg)
    if quantize:
        jp = dict(jp, layers=jax_quantize_tree(jp["layers"], predicate=lambda p: True))
    cfg, tp = _port(jcfg, jp)
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("offset,atol", [(0, 1e-6), (7, 1e-6), (499, 1e-4)])
def test_sinusoidal_positions_match_jax(offset, atol):
    want = np.asarray(jax_positions(jnp.float32(offset), 3, 64))
    got = sinusoidal_positions(offset, 3, 64).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_init_tree_matches_jax():
    jcfg = jmg.tiny_musicgen_config()
    want = jax.eval_shape(lambda: jmg.init_musicgen(jax.random.PRNGKey(0), jcfg))
    got = tmg.init_musicgen(torch.Generator().manual_seed(0), tmg.MusicGenConfig(**dataclasses.asdict(jcfg)))
    wl, gl = jax.tree.leaves_with_path(want), jax.tree.leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    assert all(tuple(g.shape) == tuple(w.shape) for (_, g), (_, w) in zip(gl, wl))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_condition_text_and_cross_kv_match_jax(quantize):
    jcfg, jp, cfg, tp = _setup(quantize)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 5, jcfg.text_d_model)).astype(np.float32)
    jcond = jmg.condition_text(jp, jnp.asarray(feats))
    tcond = tmg.condition_text(tp, torch.from_numpy(feats))
    np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), atol=ATOL)
    jk, jv = jmg.precompute_cross_kv(jp, jcfg, jcond)
    tk, tv = tmg.precompute_cross_kv(tp, cfg, tcond)
    assert tk.shape == jk.shape == (jcfg.num_hidden_layers, 2, 5, jcfg.num_attention_heads,
                                    jcfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("quantize,cond_len", [(False, None), (True, [2, 5, 3, 5])],
                         ids=["f32", "int8_cond_len"])
def test_decode_step_matches_jax_over_several_steps(quantize, cond_len):
    """The plain layer loop, 4 steps into a 6-row cache: logits and the
    cache rows written so far."""
    jcfg, jp, cfg, tp = _setup(quantize)
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((4, 5, jcfg.hidden_size)).astype(np.float32)
    jckv = jmg.precompute_cross_kv(jp, jcfg, jnp.asarray(cond))
    tckv = tmg.precompute_cross_kv(tp, cfg, torch.from_numpy(cond))
    jkc, jvc = jmg.init_kv_cache(jcfg, 4, 6, jnp.float32)
    tkc, tvc = tmg.init_kv_cache(cfg, 4, 6, torch.float32)
    jcl = None if cond_len is None else jnp.asarray(cond_len, jnp.int32)
    tcl = None if cond_len is None else torch.tensor(cond_len, dtype=torch.int32)
    for off in range(4):
        tok = rng.integers(0, jcfg.codebook_size + 1, (4, 1, jcfg.num_codebooks))
        jl, jkc, jvc = jmg.decode_step(jp, jcfg, jnp.asarray(tok), jckv, jkc, jvc, jnp.int32(off),
                                       cond_len=jcl)
        tl, tkc, tvc = tmg.decode_step(tp, cfg, torch.from_numpy(tok), tckv, tkc, tvc, off,
                                       cond_len=tcl)
        assert tl.shape == jl.shape == (4, 1, jcfg.codebook_size, jcfg.num_codebooks)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=ATOL)
        np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), atol=ATOL)


def test_top_k_sample_at_k1_is_the_argmax_as_in_jax():
    logits = np.random.default_rng(2).standard_normal((16, 4)).astype(np.float32)  # (V, K)
    want = np.asarray(jmg.top_k_sample(jax.random.PRNGKey(0), jnp.asarray(logits), 1, 1.0))
    got = tmg.top_k_sample(torch.Generator().manual_seed(0), torch.from_numpy(logits), 1, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    batched = tmg.top_k_sample(torch.Generator().manual_seed(1), torch.from_numpy(np.stack([logits] * 3)),
                               1, 0.7)
    assert batched.shape == (3, 4) and (batched.numpy() == want).all()


def test_top_k_sample_stays_in_the_top_k():
    logits = torch.tensor([[10.0, 5.0, 1.0, -3.0]] * 2).T  # (V=4, K=2)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([tmg.top_k_sample(g, logits, 2, 1.0) for _ in range(200)])
    assert (draws < 2).all() and (draws == 1).any()  # both of the top 2 occur


@pytest.mark.parametrize("ffn_mult,fused", [(2, False), (4, True)])
def test_generate_routes_like_jax(monkeypatch, ffn_mult, fused):
    """The fused step when the weights are packable and ffn = 4h, the plain
    layer loop otherwise (model.py:415-423 of the JAX package)."""
    cfg = tmg.tiny_musicgen_config(ffn_dim=ffn_mult * 32)
    params = tmg.init_musicgen(torch.Generator().manual_seed(0), cfg)
    calls = {"fused": 0, "plain": 0}
    real_fused, real_plain = tmg.decode_step_fused, tmg.decode_step

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tmg, "decode_step_fused", count("fused", real_fused))
    monkeypatch.setattr(tmg, "decode_step", count("plain", real_plain))
    codes = tmg.generate(params, cfg, torch.randn(1, 3, 32), max_steps=6, top_k=2)
    assert codes.shape == (1, 4, 3)
    assert calls == ({"fused": 6, "plain": 0} if fused else {"fused": 0, "plain": 6})


def test_generate_with_cond_len_and_live_steps_matches_jax():
    """Two samples in one loop with their own conditioning lengths and
    durations (the delay ramp-down follows each live_steps), at top_k = 1."""
    jcfg, jp, cfg, tp = _setup()
    cond = np.random.default_rng(3).standard_normal((2, 5, jcfg.hidden_size)).astype(np.float32)
    cond[1, 3:] = 0.0
    live, cl = [10, 12], [5, 3]
    want = jmg.generate(jp, jcfg, jnp.asarray(cond), max_steps=12, top_k=1,
                        key=jax.random.PRNGKey(0), live_steps=jnp.asarray(live, jnp.int32),
                        cond_len=jnp.asarray(cl, jnp.int32))
    got = tmg.generate(tp, cfg, torch.from_numpy(cond), max_steps=12, top_k=1,
                       live_steps=torch.tensor(live), cond_len=cl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # sample 0 ended at step 10: its last codebooks ramped down to BOS
    assert (got[0, -1, -2:] == cfg.bos_token_id).all() and (got[1, -1, -2:] != cfg.bos_token_id).all()


def test_generate_with_per_sample_generators():
    """One sampling stream per sample: two samples of one prompt with equal
    seeds give equal codes, with different seeds different codes, and one
    sample with its own generator draws what the shared generator draws."""
    cfg = tmg.tiny_musicgen_config()
    params = tmg.init_musicgen(torch.Generator().manual_seed(0), cfg)
    cond = torch.randn(1, 3, cfg.hidden_size, generator=torch.Generator().manual_seed(1)).expand(2, 3, -1)

    def run(seeds, n=2):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return tmg.generate(params, cfg, cond[:n], max_steps=10, top_k=8, generators=gens)

    same, diff = run([5, 5]), run([5, 6])
    assert torch.equal(same[0], same[1]) and torch.equal(diff[0], same[0])
    assert not torch.equal(diff[0], diff[1])
    alone = tmg.generate(params, cfg, cond[:1], max_steps=10, top_k=8,
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(run([5], n=1), alone)
    with pytest.raises(ValueError):
        run([5], n=2)
