"""EnCodec decode: the port against the JAX package at tiny size in f32 —
the whole decode (plain and chunked with overlap-add, weight-norm and
time-group-norm variants), the hand-built reflect padding at its edges, the
transposed conv's layout and trimming, and the param tree. Tolerance atol
1e-5: both sides run the same f32 convolutions, the LSTM recurrence and the
quantizer sums."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.musicgen import encodec as je
from flux_generator_tpu_torch.io.params import to_torch
from flux_generator_tpu_torch.models.musicgen import encodec as te

ATOL = 1e-5


def _port_cfg(jcfg):
    return te.EncodecConfig(**dataclasses.asdict(jcfg))


def _models(seed=0, **overrides):
    jcfg = je.tiny_encodec_config(**overrides)
    jm = je.EncodecModel.random_init(jcfg, jax.random.PRNGKey(seed))
    tm = te.EncodecModel(_port_cfg(jcfg), to_torch(jax.tree.map(np.asarray, jm.params)))
    return jm, tm


def _codes(cfg, shape_t, seed=1, frames=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.codebook_size, (frames, 1, cfg.num_quantizers, shape_t))


@pytest.mark.parametrize("overrides", [{}, {"norm_type": "time_group_norm"},
                                       {"use_causal_conv": True, "trim_right_ratio": 0.5},
                                       {"num_lstm_layers": 2, "num_filters": 8}],
                         ids=["default", "time_group_norm", "causal", "two_lstm_layers"])
def test_decode_matches_jax(overrides):
    jm, tm = _models(**overrides)
    codes = _codes(jm.cfg, 12)
    want = np.asarray(jm.decode(jnp.asarray(codes), [None]))
    got = tm.decode(torch.from_numpy(codes), [None]).numpy()
    assert got.shape == want.shape == (1, 12 * jm.cfg.hop_length, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_chunked_decode_with_overlap_add_matches_jax():
    jm, tm = _models(chunk_length_s=0.1, overlap=0.5)  # 80-sample frames, stride 40
    assert tm.cfg.chunk_length == 80 and tm.cfg.chunk_stride == 40
    codes = _codes(jm.cfg, 10, frames=3)
    scales = [None, None, None]
    want = np.asarray(jm.decode(jnp.asarray(codes), scales))
    got = tm.decode(torch.from_numpy(codes), scales).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_padding_mask_trims_the_output():
    jm, tm = _models()
    codes = _codes(jm.cfg, 6)
    mask = np.ones((1, 40), bool)
    want = np.asarray(jm.decode(jnp.asarray(codes), [None], jnp.asarray(mask)))
    got = tm.decode(torch.from_numpy(codes), [None], torch.from_numpy(mask)).numpy()
    assert got.shape == (1, 40, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("length,pad", [(5, (2, 3)), (5, (4, 4)), (5, (0, 5)), (5, (3, 0)),
                                        (1, (0, 1)), (7, (6, 6))])
@pytest.mark.parametrize("mode", ["reflect", "constant"])
def test_pad1d_matches_jax_at_the_edges(length, pad, mode):
    """Right pads as long as the input clamp their start at 0 (JAX
    encodec.py:270); F.pad's reflect would refuse them."""
    x = np.random.default_rng(2).standard_normal((2, length, 3)).astype(np.float32)
    want = np.asarray(je._pad1d(jnp.asarray(x), pad, mode))
    got = te._pad1d(torch.from_numpy(x), pad, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,stride,causal", [(8, 4, False), (10, 5, False), (4, 2, True),
                                             (16, 8, True)])
def test_dec_convtr_layout_and_trim_match_jax(k, stride, causal):
    """The HIO kernel is time-flipped at load: the port's ConvTranspose1d
    flips it back, then trims pl/pr as the JAX lhs-dilated conv does."""
    cfg = je.tiny_encodec_config(use_causal_conv=causal, trim_right_ratio=0.5)
    rng = np.random.default_rng(3)
    p = {"conv": {"kernel": rng.standard_normal((k, 6, 4)).astype(np.float32),
                  "bias": rng.standard_normal((4,)).astype(np.float32)}}
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    want = np.asarray(je._dec_convtr(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x), k, stride))
    got = te._dec_convtr(to_torch(p), _port_cfg(cfg), torch.from_numpy(x), k, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("k,stride,dilation", [(7, 1, 1), (3, 1, 2), (8, 4, 1)])
def test_enc_conv_matches_jax(k, stride, dilation):
    cfg = je.tiny_encodec_config()
    rng = np.random.default_rng(4)
    p = {"conv": {"kernel": rng.standard_normal((k, 5, 3)).astype(np.float32),
                  "bias": rng.standard_normal((3,)).astype(np.float32)}}
    x = rng.standard_normal((1, 23, 5)).astype(np.float32)
    want = np.asarray(je._enc_conv(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x), k, stride,
                                   dilation))
    got = te._enc_conv(to_torch(p), _port_cfg(cfg), torch.from_numpy(x), k, stride, dilation).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cfg_name", ["tiny", "full"])
def test_init_tree_matches_jax(cfg_name):
    """Both halves and the quantizer, with the JAX shapes and types (the full
    32 kHz config is checked by shape only)."""
    jcfg = je.tiny_encodec_config() if cfg_name == "tiny" else je.EncodecConfig()
    want = jax.eval_shape(lambda: je.init_encodec(jax.random.PRNGKey(0), jcfg))
    if cfg_name == "tiny":
        got = te.init_encodec(torch.Generator().manual_seed(0), _port_cfg(jcfg))
    else:
        with torch.device("meta"):
            got = te.init_encodec(None, _port_cfg(jcfg), device="meta")
    want_leaves = jax.tree.leaves_with_path(want)
    got_leaves = jax.tree.leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32


def test_decoder_spec_and_config_match_jax():
    for jcfg in (je.tiny_encodec_config(), je.EncodecConfig()):
        tcfg = _port_cfg(jcfg)
        assert te.decoder_spec(tcfg) == je.decoder_spec(jcfg)
        assert te.encoder_spec(tcfg) == je.encoder_spec(jcfg)
        assert (tcfg.hop_length, tcfg.frame_rate, tcfg.num_quantizers) == \
            (jcfg.hop_length, jcfg.frame_rate, jcfg.num_quantizers)
    full = te.EncodecConfig()
    assert (full.hop_length, full.frame_rate, full.num_quantizers) == (640, 50, 4)
    assert [e for e in te.decoder_spec(full) if e[0] == "lstm"] == [("lstm", 1024)]
