"""The port's overlap-tiled decode and per-image batching (ops/tiling.py,
autoencoder.decode_tiled) against flux_generator_tpu/ops/tiling.py on the
same decode functions, params and numpy inputs, in the cases of
tests/test_models_flux.py: a single tile, non-square inputs with one side
below the tile, the fractional-factor encode, per-image against batched, and
the Flux pipeline's batched decode.

Tolerance: the tiny VAE in f32 on the CPU; XLA's and PyTorch's convolutions
and group norms sum in other orders (a few f32 ulps through a handful of
layers), and the blending is the same f32 arithmetic on both sides: atol
1e-5 on outputs of order 1. The fake decoder of the batching cases is
elementwise, so those compare exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.flux import autoencoder as jae
from flux_generator_tpu.ops import tiling as jtiling
from flux_generator_tpu_torch.models.flux import autoencoder as tae
from flux_generator_tpu_torch.ops import tiling as ttiling
from tests.test_torch_bridge import jax_to_torch

ATOL = 1e-5


@pytest.fixture(scope="module")
def ae():
    cfg = jae.tiny_ae_config()
    params = jae.init_autoencoder(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, params, jax_to_torch(params)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 6, 6), (1, 20, 12), (1, 6, 18), (1, 18, 6), (2, 20, 12)],
                         ids=["single_tile", "tiled", "nonsquare_h_below", "nonsquare_w_below", "batch2"])
def test_decode_tiled_matches_jax(ae, shape):
    cfg, jparams, tparams = ae
    z = _normal(1, *shape, cfg.z_channels)
    want = np.asarray(jae.decode_tiled(jparams, cfg, jnp.asarray(z), tile=8, overlap=4))
    got = tae.decode_tiled(tparams, cfg, torch.from_numpy(z), tile=8, overlap=4)
    f = tae.downsample(cfg)
    assert got.shape == (shape[0], shape[1] * f, shape[2] * f, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if shape == (1, 6, 6):  # one tile: the plain decode
        np.testing.assert_array_equal(got.numpy(), tae.decode(tparams, cfg, torch.from_numpy(z)).numpy())


@pytest.mark.parametrize("shape", [(1, 8, 8), (1, 20, 12), (1, 12, 20)], ids=["single_tile", "tiled", "wide"])
def test_tiled_encode_fractional_factor_matches_jax(ae, shape):
    """factor 1/f: image tiles map to latent tiles, the blend runs at the
    latent's resolution."""
    cfg, jparams, tparams = ae
    f = tae.downsample(cfg)
    x = _normal(2, *shape, 3)
    want = np.asarray(jtiling.tiled_decode_2d(lambda xt: jae.encode(jparams, cfg, xt), jnp.asarray(x),
                                              tile=8, overlap=4, factor=1 / f))
    got = ttiling.tiled_decode_2d(lambda xt: tae.encode(tparams, cfg, xt), torch.from_numpy(x),
                                  tile=8, overlap=4, factor=1 / f)
    assert got.shape == (shape[0], shape[1] // f, shape[2] // f, cfg.z_channels) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_tile_geometry_must_scale_to_integers():
    z = torch.zeros(1, 20, 12, 3)
    with pytest.raises(ValueError, match="not integral"):
        ttiling.tiled_decode_2d(lambda t: t[:, ::8, ::8], z, tile=8, overlap=4, factor=1 / 8)


def test_blend_weights_match_jax_on_a_constant_decoder():
    """A decoder that returns ones: the blend's weights sum to exactly one
    everywhere, interior seams included (the division by max(wsum, 1e-6))."""
    z = np.zeros((1, 20, 12, 2), np.float32)

    def up(t):
        return (t.shape[0], 2 * t.shape[1], 2 * t.shape[2], 1)

    want = np.asarray(jtiling.tiled_decode_2d(lambda t: jnp.ones(up(t)), jnp.asarray(z), tile=8, overlap=4,
                                              factor=2))
    got = ttiling.tiled_decode_2d(lambda t: torch.ones(up(t)), torch.from_numpy(z), tile=8, overlap=4, factor=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("limit", [8 * 8, 3 * 8 * 8], ids=["per_image", "batched"])
def test_batched_apply_matches_jax(limit):
    """Above the limit one call per image, below it one batched call; the
    values equal the batched call's either way."""
    z = _normal(3, 3, 8, 8, 4)
    calls = []

    def fake_t(t):
        calls.append(tuple(t.shape))
        return torch.tanh(t) * 2.0 + torch.arange(t.shape[1], dtype=t.dtype)[None, :, None, None]

    def fake_j(t):
        return jnp.tanh(t) * 2.0 + jnp.arange(t.shape[1])[None, :, None, None]

    want = np.asarray(jtiling.batched_apply(fake_j, jnp.asarray(z), pixel_limit=limit))
    got = ttiling.batched_apply(fake_t, torch.from_numpy(z), pixel_limit=limit)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert calls == ([(1, 8, 8, 4)] * 3 if limit == 64 else [(3, 8, 8, 4)])


def test_flux_batched_decode_matches_jax_and_single():
    """The pipeline's decode of two 96² latents (past the 128² limit of B·h·w,
    so one image at a time) equals JAX's and each image decoded alone."""
    from flux_generator_tpu.pipelines import flux as jflux
    from flux_generator_tpu_torch.pipelines import flux as tflux

    pipe_j = jflux.FluxPipeline.random_init("flux-schnell", tiny=True, dtype=jnp.float32)
    pipe_t = tflux.FluxPipeline("flux-schnell", jax_to_torch(pipe_j.params), pipe_j.flow_cfg, pipe_j.ae_cfg,
                                pipe_j.clip_cfg, pipe_j.t5_cfg, dtype=torch.float32)
    h = w = 96
    x = _normal(4, 2, (h // 2) * (w // 2), pipe_j.ae_cfg.z_channels * 4)
    want = np.asarray(pipe_j.decode(jnp.asarray(x), (h, w)))
    both = pipe_t.decode(torch.from_numpy(x), (h, w)).numpy()
    np.testing.assert_allclose(both, want, rtol=0, atol=ATOL)
    for i in range(2):
        np.testing.assert_array_equal(both[i], pipe_t.decode(torch.from_numpy(x[i:i + 1]), (h, w)).numpy()[0])
