"""Coalesced MusicGen requests in the port (the counterpart of
tests/test_musicgen_coalesce.py, without its server test): several users'
requests — different prompts (lengths), durations and seeds — in one batched
AR loop.

Contract, at tiny size in f32 on the CPU: at top_k 1 each coalesced
request's codes equal a solo run of it at its own conditioning length, on
both routes (the plain layer loop, ffn = 2h; the fused step, ffn = 4h) and
both cache types (bf16 = the activation dtype, and e4m3); with a generator
per request, at top_k 4 as well; padding a prompt to a larger S bucket under
its cond_len mask changes nothing. `generate_requests` matches the JAX
pipeline's at top_k 1: codes equal, waveforms within atol 1e-5 (f32 EnCodec
on both sides, as tests/test_torch_pipeline_musicgen.py); its durations are
clamped to 8..2500 steps and each waveform cut to its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.musicgen import model as jmg
from flux_generator_tpu.pipelines.musicgen import MusicGenPipeline as JaxPipeline
from flux_generator_tpu.runtime.config import set_musicgen_fused, set_musicgen_kv_dtype
from flux_generator_tpu_torch.io.params import to_torch
from flux_generator_tpu_torch.models.musicgen import encodec as te
from flux_generator_tpu_torch.models.musicgen import model as tmg
from flux_generator_tpu_torch.models.t5.t5 import T5Config
from flux_generator_tpu_torch.pipelines import musicgen as tpm

ATOL = 1e-5
ROUTES = {"plain_loop": 2, "fused_step": 4}  # ffn_dim / hidden_size: the route generate takes


def _setup(route, s1=5, s2=9):
    cfg = tmg.tiny_musicgen_config(ffn_dim=ROUTES[route] * 32)
    params = tmg.init_musicgen(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    c1 = torch.from_numpy((rng.standard_normal((1, s1, 32)) * 0.3).astype(np.float32))
    c2 = torch.from_numpy((rng.standard_normal((1, s2, 32)) * 0.3).astype(np.float32))
    return cfg, params, c1, c2


def _pad_to(c, s_bucket):
    out = torch.zeros((1, s_bucket, c.shape[2]))
    out[:, :c.shape[1]] = c
    return out


def _gens(*seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


@pytest.mark.parametrize("kv_dtype", ["bf16", "f8"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("top_k", [1, 4])
def test_coalesced_equals_solo(route, kv_dtype, top_k):
    """Two requests padded to one S bucket with cond_len masks, their own
    durations and generators, against each run alone at its own length."""
    cfg, params, c1, c2 = _setup(route)
    kw = dict(max_steps=16, top_k=top_k, kv_dtype=kv_dtype)
    solo1 = tmg.generate(params, cfg, c1, live_steps=12, generators=_gens(7), **kw)
    solo2 = tmg.generate(params, cfg, c2, live_steps=16, generators=_gens(8), **kw)
    both = tmg.generate(params, cfg, torch.cat([_pad_to(c1, 16), _pad_to(c2, 16)]),
                        live_steps=torch.tensor([12, 16]), cond_len=[5, 9], generators=_gens(7, 8), **kw)
    assert torch.equal(both[0], solo1[0]) and torch.equal(both[1], solo2[0])
    assert not torch.equal(both[0], both[1])


@pytest.mark.parametrize("route", list(ROUTES))
def test_padding_under_the_mask_changes_nothing(route):
    cfg, params, c1, _ = _setup(route)
    kw = dict(max_steps=16, top_k=1, cond_len=[5], generators=_gens(3))
    assert torch.equal(tmg.generate(params, cfg, c1, **kw), tmg.generate(params, cfg, _pad_to(c1, 16), **kw))


class _Tok:
    """Prompts of known token lengths (the JAX test's stand-in tokenizer)."""

    lens = {"short prompt": 3, "a much longer prompt text": 9, "a third one": 5}

    def encode(self, text, **kw):
        return [list(range(1, self.lens.get(text, 4) + 1))]


def _pipelines(route):
    """The JAX tiny pipeline (the fused route: its decoder redrawn with
    ffn = 4h) and the port's copy of it."""
    jp = JaxPipeline.random_init(jax.random.PRNGKey(0))
    if route == "fused_step":
        cfg = jmg.tiny_musicgen_config(ffn_dim=4 * jp.cfg.hidden_size)
        jp = JaxPipeline(cfg, jmg.init_musicgen(jax.random.PRNGKey(7), cfg), jp.t5_cfg, jp.t5_params,
                         jp.audio_decoder)
    conv = lambda t: to_torch(jax.tree.map(np.asarray, t))  # noqa: E731
    tp = tpm.MusicGenPipeline(
        tmg.MusicGenConfig(**dataclasses.asdict(jp.cfg)), conv(jp.params),
        T5Config(**dataclasses.asdict(jp.t5_cfg)), conv(jp.t5_params),
        te.EncodecModel(te.EncodecConfig(**dataclasses.asdict(jp.audio_decoder.cfg)),
                        conv(jp.audio_decoder.params)))
    jp.tokenizer = tp.tokenizer = _Tok()
    return jp, tp


REQUESTS = [{"text": "short prompt", "max_steps": 10, "seed": 11},
            {"text": "a much longer prompt text", "max_steps": 14, "seed": 22},
            {"text": "a third one", "max_steps": 12, "seed": None}]


@pytest.mark.parametrize("route,kv_dtype", [("plain_loop", "bf16"), ("fused_step", "f8")])
def test_generate_requests_matches_jax(route, kv_dtype):
    """Three requests through both pipelines' generate_requests at top_k 1:
    the JAX one under its FGT_MG_KV knob (and the fused route switched on),
    the port's with kv_dtype; every waveform within ATOL, in request order;
    the trace splits the request and keeps each request's codes."""
    jp, tp = _pipelines(route)
    set_musicgen_kv_dtype(kv_dtype)
    set_musicgen_fused(True if route == "fused_step" else None)
    try:
        want = [np.asarray(a) for a in jp.generate_requests(REQUESTS, top_k=1)]
    finally:
        set_musicgen_kv_dtype(None)
        set_musicgen_fused(None)
    tp.kv_dtype = kv_dtype
    trace = {}
    got = tp.generate_requests(REQUESTS, top_k=1, trace=trace)
    hop, k = tp.audio_decoder.cfg.hop_length, tp.cfg.num_codebooks
    assert [g.shape for g in got] == [w.shape for w in want] == [((r["max_steps"] - k + 1) * hop, 1)
                                                                  for r in REQUESTS]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)
    assert {"conditioning_s", "ar_s", "decode_s", "codes"} <= set(trace)
    assert [c.shape[-1] for c in trace["codes"]] == [r["max_steps"] - k + 1 for r in REQUESTS]


def test_generate_requests_equals_solo_requests():
    """At the pipeline level, on e4m3 caches: each coalesced waveform equals
    the request served alone."""
    _, tp = _pipelines("fused_step")
    tp.kv_dtype = "f8"
    both = tp.generate_requests(REQUESTS[:2], top_k=1)
    for wave, request in zip(both, REQUESTS[:2]):
        assert torch.equal(wave, tp.generate_requests([request], top_k=1)[0])


def test_durations_are_clamped_and_cut_per_request(monkeypatch):
    """Durations outside 8..2500 are clamped, the loop runs the longest, and
    each request's codes are cut to its own length before its decode."""
    _, tp = _pipelines("plain_loop")
    seen = {}

    def fake_generate(params, cfg, cond, max_steps, *args, live_steps=None, cond_len=None, **kw):
        seen.update(max_steps=max_steps, live=live_steps.tolist(), cond_len=list(cond_len),
                    s=cond.shape[1], kv_dtype=kw["kv_dtype"], n_gens=len(kw["generators"]))
        n = cond.shape[0]
        return torch.arange(n * cfg.num_codebooks * (max_steps - 3)).reshape(n, cfg.num_codebooks, -1) % 16

    monkeypatch.setattr(tpm.mg, "generate", fake_generate)
    requests = [{"text": "short prompt", "max_steps": 2}, {"text": "a much longer prompt text", "max_steps": 9000},
                {"text": "a third one", "max_steps": 40}]
    trace = {}
    waves = tp.generate_requests(requests, top_k=1, trace=trace)
    assert seen == dict(max_steps=2500, live=[8, 2500, 40], cond_len=[3, 9, 5], s=16, kv_dtype="bf16", n_gens=3)
    hop = tp.audio_decoder.cfg.hop_length
    assert [w.shape[0] for w in waves] == [5 * hop, 2497 * hop, 37 * hop]
    assert [c.shape for c in trace["codes"]] == [(1, 4, 5), (1, 4, 2497), (1, 4, 37)]


def test_pow2_bucket_and_kv_dtype_checks():
    assert [tpm._next_pow2_bucket(s) for s in (1, 16, 17, 33, 64)] == [16, 16, 32, 64, 64]
    with pytest.raises(ValueError):
        tpm.MusicGenPipeline.random_init(tiny=True, generator=torch.Generator().manual_seed(0), kv_dtype="f16")
    pipe = tpm.MusicGenPipeline.random_init(tiny=True, generator=torch.Generator().manual_seed(0), kv_dtype="f8")
    assert pipe.kv_dtype == "f8"
