"""The MusicGen pipeline end to end: the port against the JAX pipeline at
tiny size in f32 and top_k = 1, on both routes — the plain layer loop
(tiny_musicgen_config, ffn = 2h) and the fused step (ffn = 4h, the JAX side
with set_musicgen_fused(True), its Pallas kernel in interpret mode). Codes
must be equal; the waveform within atol 1e-5 (f32 EnCodec on both sides).

The JAX pipeline runs a 64-step compile bucket with live_steps = max_steps
(pipelines/musicgen.py:138); the port runs exactly max_steps steps. The
codes agree because steps past max_steps never reach the first
max_steps - K + 1 output columns."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.musicgen import model as jmg
from flux_generator_tpu.pipelines.musicgen import MusicGenPipeline as JaxPipeline
from flux_generator_tpu.runtime.config import set_musicgen_fused
from flux_generator_tpu_torch.io.params import to_torch
from flux_generator_tpu_torch.io.registry import musicgen_configs
from flux_generator_tpu_torch.models.musicgen import encodec as te
from flux_generator_tpu_torch.models.musicgen import model as tmg
from flux_generator_tpu_torch.models.t5.t5 import T5Config
from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline

STEPS = 20
ATOL = 1e-5
SPM = "tests/assets/spiece/t5_like.model"


def _port_of(jp):
    conv = lambda t: to_torch(jax.tree.map(np.asarray, t))  # noqa: E731
    return MusicGenPipeline(
        tmg.MusicGenConfig(**dataclasses.asdict(jp.cfg)), conv(jp.params),
        T5Config(**dataclasses.asdict(jp.t5_cfg)), conv(jp.t5_params),
        te.EncodecModel(te.EncodecConfig(**dataclasses.asdict(jp.audio_decoder.cfg)),
                        conv(jp.audio_decoder.params)))


def _jax_pipeline(fused: bool):
    jp = JaxPipeline.random_init(jax.random.PRNGKey(0))
    if fused:
        cfg = jmg.tiny_musicgen_config(ffn_dim=4 * jp.cfg.hidden_size)
        jp = JaxPipeline(cfg, jmg.init_musicgen(jax.random.PRNGKey(7), cfg), jp.t5_cfg, jp.t5_params,
                         jp.audio_decoder)
    return jp


def _jax_run(jp, cond, fused: bool):
    """The JAX pipeline's own bucketed run: its codes (through the jitted
    program generate() calls) and its waveform."""
    set_musicgen_fused(True if fused else None)
    try:
        bucket = 64
        codes = jp._generate(jp.params, cond, jax.random.PRNGKey(0), bucket, 1, 1.0, 3.0,
                             jnp.int32(STEPS))
        audio = jp.generate("", max_steps=STEPS, top_k=1, seed=0, conditioning=cond)
    finally:
        set_musicgen_fused(None)
    return np.asarray(codes), np.asarray(audio)


@pytest.fixture(scope="module", params=[False, True], ids=["plain_loop", "fused_step"])
def runs(request):
    fused = request.param
    jp = _jax_pipeline(fused)
    tp = _port_of(jp)
    cond = np.random.default_rng(0).standard_normal((1, 5, jp.cfg.hidden_size)).astype(np.float32)
    jcodes, jaudio = _jax_run(jp, jnp.asarray(cond), fused)
    trace = {}
    taudio = tp.generate("", max_steps=STEPS, top_k=1, seed=0, conditioning=torch.from_numpy(cond),
                         trace=trace)
    return dict(jp=jp, tp=tp, fused=fused, jcodes=jcodes, jaudio=jaudio, tcodes=trace["codes"].numpy(),
                taudio=taudio.numpy(), trace=trace)


def test_codes_equal_jax(runs):
    want = runs["jcodes"][:, :, :STEPS - runs["jp"].cfg.num_codebooks + 1]
    np.testing.assert_array_equal(runs["tcodes"], want)


def test_waveform_matches_jax(runs):
    assert runs["taudio"].shape == runs["jaudio"].shape == (
        (STEPS - runs["jp"].cfg.num_codebooks + 1) * runs["jp"].audio_decoder.cfg.hop_length, 1)
    np.testing.assert_allclose(runs["taudio"], runs["jaudio"], atol=ATOL)


def test_exact_step_count_matches_the_bucketed_run(runs):
    """The port ran STEPS steps, the JAX side its 64-step bucket: the first
    STEPS - K + 1 columns agree, and past them the bucket only holds the BOS
    ramp-down that live_steps imposes."""
    k = runs["jp"].cfg.num_codebooks
    assert runs["tcodes"].shape[-1] == STEPS - k + 1
    assert runs["jcodes"].shape[-1] == 64 - k + 1
    assert (runs["jcodes"][:, :, STEPS - k + 1:] == runs["jp"].cfg.bos_token_id).all()
    np.testing.assert_array_equal(runs["tcodes"], runs["jcodes"][:, :, :STEPS - k + 1])


def test_trace_splits_the_request(runs):
    assert set(runs["trace"]) == {"conditioning_s", "ar_s", "decode_s", "codes"}
    assert all(runs["trace"][key] >= 0 for key in ("conditioning_s", "ar_s", "decode_s"))


def test_conditioning_matches_jax():
    from flux_generator_tpu.tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer

    jp = _jax_pipeline(False)
    tp = _port_of(jp)
    jp.tokenizer = tp.tokenizer = SentencePieceUnigramTokenizer.from_file(SPM, max_length=256)
    want = np.asarray(jp.conditioning("slow piano ballad"))
    got = tp.conditioning("slow piano ballad")
    assert got.shape == want.shape and got.shape[0] == 1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_generate_batch_and_n_samples():
    from flux_generator_tpu_torch.io.tokenizers import load_t5_tokenizer

    pipe = MusicGenPipeline.random_init(tiny=True, generator=torch.Generator().manual_seed(1))
    pipe.tokenizer = load_t5_tokenizer(SPM)
    waves = pipe.generate_batch("happy rock", n_samples=3, max_steps=10, top_k=4, seed=2)
    hop = pipe.audio_decoder.cfg.hop_length
    assert waves.shape == (3, 7 * hop, 1) and torch.isfinite(waves).all()
    first = pipe.generate("happy rock", max_steps=10, top_k=4, seed=2, n_samples=3)
    np.testing.assert_allclose(first.numpy(), waves[0].numpy(), atol=ATOL)
    with pytest.raises(TypeError):
        pipe.generate_batch("happy rock", n_samples=2, steps=10)


def test_random_init_is_seeded():
    a = MusicGenPipeline.random_init(tiny=True, generator=torch.Generator().manual_seed(3))
    b = MusicGenPipeline.random_init(tiny=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.params["emb"], b.params["emb"])
    cond = torch.randn(1, 3, a.cfg.hidden_size)
    wa = a.generate("", max_steps=8, top_k=4, seed=5, conditioning=cond)
    wb = b.generate("", max_steps=8, top_k=4, seed=5, conditioning=cond)
    assert torch.equal(wa, wb)


def test_full_size_configs_are_musicgen_medium():
    from flux_generator_tpu.models.musicgen.encodec import EncodecConfig as JaxEncodecConfig

    cfg, t5, enc = musicgen_configs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jmg.MusicGenConfig())
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
            cfg.ffn_dim, cfg.num_codebooks, cfg.codebook_size) == (48, 1536, 24, 64, 6144, 4, 2048)
    assert (t5.num_layers, t5.d_model, t5.num_heads, t5.d_kv, t5.d_ff, t5.feed_forward_proj,
            t5.tie_word_embeddings) == (12, 768, 12, 64, 3072, "relu", True)
    assert dataclasses.asdict(enc) == dataclasses.asdict(JaxEncodecConfig())
    assert cfg.text_d_model == t5.d_model
