"""The port's EnCodec encode side (models/musicgen/encodec.py: rvq_encode,
EncodecModel.encode with its chunked protocol and checks,
preprocess_audio) and the 1-D convs it runs on (ops/linear.py: conv1d,
conv_transpose1d), held against the JAX package on the CPU at tiny configs:
the same params (JAX init, bridged) and the same seeded numpy audio.
Convs and embeddings in f32 within 1e-5; codes, frames and scales' shapes
equal exactly, scales within 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.musicgen import encodec as jenc
from flux_generator_tpu.ops import linear as jlin
from flux_generator_tpu_torch.models.musicgen import encodec as enc
from flux_generator_tpu_torch.models.musicgen.encodec import EncodecConfig
from flux_generator_tpu_torch.ops import linear
from tests.test_torch_bridge import jax_to_torch

TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 3, 1), (3, (2, 5), 1), (1, [(1, 0)], 2)])
def test_conv1d_matches_jax(stride, padding, groups):
    x = _rand(2, 23, 6)
    p = {"kernel": _rand(5, 6 // groups, 4, seed=1), "bias": _rand(4, seed=2)}
    want = jlin.conv1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride, padding, groups)
    got = linear.conv1d({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), stride, padding,
                        groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 4), (4, 8)])
def test_conv_transpose1d_matches_jax(stride, k):
    x = _rand(2, 9, 6)
    p = {"kernel": _rand(k, 6, 3, seed=1), "bias": _rand(3, seed=2)}
    want = jlin.conv_transpose1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride)
    got = linear.conv_transpose1d({k_: torch.from_numpy(v) for k_, v in p.items()}, torch.from_numpy(x), stride)
    assert got.shape == want.shape == (2, (9 - 1) * stride + k, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_rvq_encode_codes_equal():
    rng = np.random.RandomState(4)
    quantizer = [{"embed": rng.randn(16, 8).astype(np.float32)} for _ in range(3)]
    emb = rng.randn(2, 11, 8).astype(np.float32)
    want = np.asarray(jenc.rvq_encode([{"embed": jnp.asarray(q["embed"])} for q in quantizer], jnp.asarray(emb), 3))
    got = enc.rvq_encode([{"embed": torch.from_numpy(q["embed"])} for q in quantizer], torch.from_numpy(emb), 3)
    assert got.shape == (2, 3, 11)
    np.testing.assert_array_equal(got.numpy(), want)
    # fewer quantizers: the leading codebooks' codes
    np.testing.assert_array_equal(
        enc.rvq_encode([{"embed": torch.from_numpy(q["embed"])} for q in quantizer], torch.from_numpy(emb), 2).numpy(),
        want[:, :2])


CONFIGS = {
    "mono": dict(),
    "stereo": dict(audio_channels=2),
    "normalized": dict(normalize=True),
    # chunks of 100 samples, stride 60 (preprocess_audio pads to a length
    # that the protocol takes when the stride is over half the chunk)
    "chunked": dict(chunk_length_s=0.125, overlap=0.4, normalize=True),
    "two_lstm_layers": dict(num_lstm_layers=2),
}


def _models(name):
    jcfg = jenc.tiny_encodec_config(**CONFIGS[name])
    jm = jenc.EncodecModel.random_init(jcfg, jax.random.PRNGKey(1))
    cfg = EncodecConfig(**{k: getattr(jcfg, k) for k in EncodecConfig.__dataclass_fields__})
    return jm, enc.EncodecModel(cfg, jax_to_torch(jm.params))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_matches_jax(name):
    jm, tm = _models(name)
    channels = jm.cfg.audio_channels
    waves = [_rand(430, channels, seed=7), _rand(300, channels, seed=8)]
    kw = {}
    if jm.cfg.chunk_length:
        kw = dict(chunk_length=jm.cfg.chunk_length, chunk_stride=jm.cfg.chunk_stride)
    jx, jmask = jenc.preprocess_audio(waves, **kw)
    x, mask = enc.preprocess_audio(waves, **kw)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    jcodes, jscales = jm.encode(jx, jmask)
    codes, scales = tm.encode(x, mask)
    assert codes.shape == jcodes.shape and codes.dtype == torch.int64
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert len(scales) == len(jscales) == codes.shape[0]
    for s, js in zip(scales, jscales):
        if js is None:
            assert s is None
        else:
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    # the embedding before the quantizer
    frame = x[:, :jm.cfg.chunk_length or x.shape[1]]
    want = jenc._run_spec(jm.params["encoder"], jenc.encoder_spec(jm.cfg), jm.cfg, jnp.asarray(frame.numpy()))
    np.testing.assert_allclose(tm.embed(frame).numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_encode_then_decode_round_trips_the_length():
    jm, tm = _models("mono")
    x, mask = enc.preprocess_audio(_rand(400, seed=3))
    codes, scales = tm.encode(x, mask)
    audio = tm.decode(codes, scales, mask)
    want = jm.decode(jnp.asarray(codes.numpy()), [None], jnp.asarray(mask.numpy()))
    assert audio.shape == (1, 400, 1)
    np.testing.assert_allclose(audio.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_preprocess_audio_matches_jax():
    waves = [_rand(37, seed=1).astype(np.float64), _rand(50, seed=2)]
    for kw in ({}, dict(chunk_length=16, chunk_stride=8)):
        jx, jmask = jenc.preprocess_audio(waves, **kw)
        x, mask = enc.preprocess_audio([torch.from_numpy(waves[0]), waves[1]], **kw)
        assert x.dtype == torch.float32 and str(jx.dtype) == "float32"
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    jx, _ = jenc.preprocess_audio(_rand(9))
    x, _ = enc.preprocess_audio(_rand(9))
    assert x.shape == jx.shape == (1, 9, 1)


def test_bandwidth_and_input_checks_raise_as_jax():
    jm, tm = _models("chunked")
    x, mask = enc.preprocess_audio(_rand(130), chunk_length=jm.cfg.chunk_length, chunk_stride=jm.cfg.chunk_stride)
    for model, xs in ((jm, jnp.asarray(x.numpy())), (tm, x)):
        with pytest.raises(ValueError, match="unsupported bandwidth"):
            model.encode(xs, bandwidth=1.5)
        with pytest.raises(ValueError, match="1 or 2 channels"):
            model.encode(xs[..., [0, 0, 0]])
        with pytest.raises(ValueError, match="not padded"):
            model.encode(xs[:, :-1])
    for bw in (None, 0.0, 0.4, 0.8, 100.0):
        assert tm.num_quantizers_for_bandwidth(bw) == jm.num_quantizers_for_bandwidth(bw)
