"""The ported Flux text-to-image slice as a whole (CPU, f32, tiny config).

(a) the port reproduces tests/golden/flux_tiny.npz from the params and inputs
    tests/make_golden.py builds, at the atol of tests/test_golden.py;
(b) tokens → prepare_conditioning (int4 T5, CLIP) → denoise_latents (int8
    flow, injected noise) → decode / decode_u8 match the JAX pipeline's
    methods of the same names."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
from flux_generator_tpu.pipelines import flux as jflux
from flux_generator_tpu_torch.io.params import to_numpy
from flux_generator_tpu_torch.pipelines import flux as tflux
from tests.test_torch_bridge import all_layers, jax_to_torch

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flux_tiny.npz"


def _port_pipeline(jpipe, params=None):
    return tflux.FluxPipeline(
        "flux-schnell", jax_to_torch(params if params is not None else jpipe.params),
        jpipe.flow_cfg, jpipe.ae_cfg, jpipe.clip_cfg, jpipe.t5_cfg, dtype=torch.float32,
    )


def test_reproduces_golden_fixture():
    pipe_j = jflux.FluxPipeline.random_init("flux-schnell", tiny=True, dtype=jnp.float32)
    b, h, w = 1, 8, 8
    x = jax.random.normal(jax.random.PRNGKey(10), (b, h, w, pipe_j.ae_cfg.z_channels))
    txt = jax.random.normal(jax.random.PRNGKey(11), (b, 4, pipe_j.flow_cfg.context_in_dim))
    vec = jax.random.normal(jax.random.PRNGKey(12), (b, pipe_j.flow_cfg.vec_in_dim))
    x, txt, vec = (torch.from_numpy(np.array(a)) for a in (x, txt, vec))

    pipe = _port_pipeline(pipe_j)
    x_t = tflux.pack_latents(x)
    out = pipe.denoise_latents(x_t, tflux.latent_ids(b, h, w), txt,
                               torch.zeros((b, 4, 3), dtype=torch.int32), vec, 2, 4.0)
    img = pipe.decode(out, (h, w))
    want = np.load(GOLDEN)
    np.testing.assert_allclose(out.numpy(), want["latent"], atol=1e-4)
    np.testing.assert_allclose(img.numpy(), want["image"], atol=1e-4)


@pytest.fixture(scope="module")
def quantized_pipelines():
    pipe_j = jflux.FluxPipeline.random_init("flux-schnell", tiny=True, dtype=jnp.float32,
                                            key=jax.random.PRNGKey(3))
    pipe_j.params["t5"] = jax_quantize_tree(pipe_j.params["t5"], all_layers, bits=4,
                                            group_size=8, pack=True)
    pipe_j.params["flow"] = jax_quantize_tree(pipe_j.params["flow"], all_layers, bits=8)
    return pipe_j, _port_pipeline(pipe_j)


def test_methods_match_jax_pipeline(quantized_pipelines):
    pipe_j, pipe_t = quantized_pipelines
    rng = np.random.default_rng(4)
    n, h, w = 2, 8, 8
    t5_tok = rng.integers(1, pipe_j.t5_cfg.vocab_size, (1, 12)).astype(np.int32)
    clip_tok = rng.integers(1, pipe_j.clip_cfg.vocab_size, (1, 7)).astype(np.int32)
    noise = rng.standard_normal((n, h, w, pipe_j.ae_cfg.z_channels)).astype(np.float32)

    txt_j, ids_j, vec_j = pipe_j.prepare_conditioning(n, jnp.asarray(t5_tok), jnp.asarray(clip_tok))
    txt_t, ids_t, vec_t = pipe_t.prepare_conditioning(n, torch.from_numpy(t5_tok).long(),
                                                      torch.from_numpy(clip_tok).long())
    np.testing.assert_allclose(txt_t.numpy(), np.asarray(txt_j), atol=1e-4)
    np.testing.assert_allclose(vec_t.numpy(), np.asarray(vec_j), atol=1e-5)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))

    x_j = jflux.pack_latents(jnp.asarray(noise))
    x_t = tflux.pack_latents(torch.from_numpy(noise))
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(tflux.latent_ids(n, h, w).numpy(), np.asarray(jflux.latent_ids(n, h, w)))
    lat_j = pipe_j.denoise_latents(x_j, jflux.latent_ids(n, h, w), txt_j, ids_j, vec_j, 4, 4.0)
    lat_t = pipe_t.denoise_latents(x_t, tflux.latent_ids(n, h, w), txt_t, ids_t, vec_t, 4, 4.0)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), atol=1e-4)

    img_j = pipe_j.decode(lat_j, (h, w))
    img_t = pipe_t.decode(lat_t, (h, w))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    u8_j = np.asarray(pipe_j.decode_u8(lat_j, (h, w)))
    u8_t = pipe_t.decode_u8(lat_t, (h, w)).numpy()
    assert u8_t.dtype == np.uint8 and u8_t.shape == u8_j.shape
    assert np.abs(u8_t.astype(int) - u8_j.astype(int)).max() <= 1


# the JAX package's FGT_W8A8_IMPL formulation of each route
W8A8_IMPL = {"ops": "xla", "rows": "pq", "fused": "pallas"}


@pytest.mark.parametrize("w8a8,attn_int8", [("fused", "qk"), ("rows", "full")])
def test_w8a8_pipeline_matches_jax_pipeline(monkeypatch, w8a8, attn_int8):
    """The W8A8 serving configuration end to end (f32, CPU): flow, T5 and
    CLIP int8 per channel with int8 activations, int8 attention, against the
    JAX pipeline under set_w8a8(True), FGT_W8A8_IMPL and set_attn_int8 with
    its Pallas attention (interpret mode). Hidden 512 with heads of 64, so
    that the Pallas attention and the K-block predicate apply; 64 image and
    16 text tokens, so that every image and text dense has m_rows ≥ 16 and
    the modulations (M = 1) take the "ops" formulation. The conditioning
    agrees to atol 2e-3 (it agrees to 5e-7 here). The latents (max|x| ≈ 4.2)
    to rel-L2 1e-3 and atol 1e-2: an int8 level (of p above all) that rounds
    the other way after a last-bit difference upstream moves an output by
    about 1/127 of one term, and two steps carry it on (measured rel-L2
    1.6e-4 and 5.9e-4; the weight-only pipeline is 3.0e-3 away)."""
    import functools
    import importlib

    from flux_generator_tpu.ops import linear as jlinear
    from flux_generator_tpu.runtime.config import set_attn_int8

    # the module (ops/pallas/__init__ re-exports its function under its name)
    jattn = importlib.import_module("flux_generator_tpu.ops.pallas.flash_attention")

    pipe_j = jflux.FluxPipeline.random_init(
        "flux-schnell", tiny=True, dtype=jnp.float32, key=jax.random.PRNGKey(6), hidden_size=512,
        num_heads=8, axes_dim=(16, 24, 24), depth=1, depth_single_blocks=1)
    for part in ("t5", "clip", "flow"):
        pipe_j.params[part] = jax_quantize_tree(pipe_j.params[part], all_layers, bits=8)
    pipe_t = _port_pipeline(pipe_j)
    pipe_t.w8a8, pipe_t.attn_int8 = w8a8, attn_int8

    rng = np.random.default_rng(8)
    h = w = 16
    t5_tok = rng.integers(1, pipe_j.t5_cfg.vocab_size, (1, 16)).astype(np.int32)
    clip_tok = rng.integers(1, pipe_j.clip_cfg.vocab_size, (1, 7)).astype(np.int32)
    noise = rng.standard_normal((1, h, w, pipe_j.ae_cfg.z_channels)).astype(np.float32)

    monkeypatch.setenv("FGT_PALLAS_ATTENTION", "1")
    monkeypatch.setenv("FGT_W8A8_IMPL", W8A8_IMPL[w8a8])
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(jattn.flash_attention, interpret=True))
    jlinear.set_w8a8(True)
    set_attn_int8(attn_int8)
    try:
        txt_j, ids_j, vec_j = pipe_j.prepare_conditioning(1, jnp.asarray(t5_tok), jnp.asarray(clip_tok))
        lat_j = pipe_j.denoise_latents(jflux.pack_latents(jnp.asarray(noise)), jflux.latent_ids(1, h, w),
                                       txt_j, ids_j, vec_j, 2, 4.0)
    finally:
        jlinear.set_w8a8(None)
        set_attn_int8(None)
    txt_t, ids_t, vec_t = pipe_t.prepare_conditioning(1, torch.from_numpy(t5_tok).long(),
                                                      torch.from_numpy(clip_tok).long())
    np.testing.assert_allclose(txt_t.numpy(), np.asarray(txt_j), atol=2e-3)
    np.testing.assert_allclose(vec_t.numpy(), np.asarray(vec_j), atol=2e-3)
    lat_t = pipe_t.denoise_latents(tflux.pack_latents(torch.from_numpy(noise)), tflux.latent_ids(1, h, w),
                                   txt_t, ids_t, vec_t, 2, 4.0)
    lat_j = np.asarray(lat_j)
    assert np.linalg.norm(lat_t.numpy() - lat_j) <= 1e-3 * np.linalg.norm(lat_j)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=1e-2)
    # the configuration is live: the weight-only pipeline gives another latent
    pipe_t.w8a8, pipe_t.attn_int8 = None, ""
    plain = pipe_t.denoise_latents(tflux.pack_latents(torch.from_numpy(noise)), tflux.latent_ids(1, h, w),
                                   txt_t, ids_t, vec_t, 2, 4.0)
    assert (plain - lat_t).abs().max().item() > 1e-3


def test_unpack_inverts_pack():
    x = torch.randn(2, 6, 10, 4)
    np.testing.assert_array_equal(tflux.unpack_latents(tflux.pack_latents(x), 6, 10).numpy(), x.numpy())


class _Tokenizer:
    def __init__(self, length, vocab):
        self.length, self.vocab = length, vocab

    def encode(self, text):
        ids = [(sum(map(ord, word)) % (self.vocab - 2)) + 1 for word in text.split()]
        return [(ids + [self.vocab - 1] * self.length)[: self.length]]


def test_generate_images_runs_the_slice(quantized_pipelines):
    _, pipe = quantized_pipelines
    pipe.t5_tokenizer = _Tokenizer(16, pipe.t5_cfg.vocab_size)
    pipe.clip_tokenizer = _Tokenizer(7, pipe.clip_cfg.vocab_size)
    trace = {}
    img = pipe.generate_images("a red fox", num_steps=2, latent_size=(8, 8), seed=1,
                               as_uint8=True, trace=trace)
    assert img.shape == (1, 16, 16, 3) and img.dtype == torch.uint8
    assert set(trace) == {"conditioning_s", "denoise_s", "decode_s", "latent"}
    assert torch.isfinite(trace["latent"]).all()
    again = pipe.generate_images("a red fox", num_steps=2, latent_size=(8, 8), seed=1, as_uint8=True)
    other = pipe.generate_images("a red fox", num_steps=2, latent_size=(8, 8), seed=2, as_uint8=True)
    assert torch.equal(img, again) and not torch.equal(img, other)


def test_tokenize_with_the_asset_tokenizers(quantized_pipelines):
    """The port's loaders give the JAX package's tokenizers; T5 rows pad to
    the flux-schnell length."""
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer

    assets = pathlib.Path(__file__).parent / "assets"
    _, pipe = quantized_pipelines
    pipe.t5_tokenizer = load_t5_tokenizer(assets / "spiece" / "t5_like.model", max_length=256)
    pipe.clip_tokenizer = load_clip_tokenizer(assets / "clip_tokenizer" / "vocab.json",
                                              assets / "clip_tokenizer" / "merges.txt")
    t5_tokens, clip_tokens = pipe.tokenize("a photo of a cat")
    assert t5_tokens.shape == (1, 256) and t5_tokens.dtype == torch.long
    assert clip_tokens[0, 0].item() == pipe.clip_tokenizer.bos_token
    assert clip_tokens[0, -1].item() == pipe.clip_tokenizer.eos_token


def test_random_init_is_seeded():
    a = tflux.FluxPipeline.random_init("flux-schnell", tiny=True, dtype=torch.float32,
                                       generator=torch.Generator().manual_seed(5))
    b = tflux.FluxPipeline.random_init("flux-schnell", tiny=True, dtype=torch.float32,
                                       generator=torch.Generator().manual_seed(5))
    for x, y in zip(jax.tree.leaves(to_numpy(a.params)), jax.tree.leaves(to_numpy(b.params))):
        np.testing.assert_array_equal(x, y)
    assert a.device == torch.device("cpu")


# ------------------------------------------------------------ the generator protocol, img2img, fused
# Noise enters both pipelines from numpy: the JAX package's sample_prior and
# jax.random.normal, the port's sample_prior, each replaced by a function
# that hands out the array of the request's seed. Latents against JAX at atol
# 1e-4 over up to 4 steps, as test_methods_match_jax_pipeline; uint8 images
# within one level.


def _seed_of_key(key):
    return int(np.asarray(jax.random.key_data(key)).ravel()[-1])


@pytest.fixture
def seeded_noise(monkeypatch):
    """seed → numpy noise, served to both packages by the shape asked for.
    Inside a jitted JAX function the key is traced: `noise.traced_seed`
    names the seed then."""
    table = {}

    def noise(seed, shape):
        key = (seed, tuple(shape))
        if key not in table:
            table[key] = np.random.default_rng(100 + seed).standard_normal(shape).astype(np.float32)
        return table[key]

    def jax_prior(key, shape, dtype):
        seed = noise.traced_seed if isinstance(key, jax.core.Tracer) else _seed_of_key(key)
        return jnp.asarray(noise(seed, shape), dtype)

    noise.traced_seed = None

    def torch_prior(generator, shape, dtype, device=None):
        return torch.from_numpy(noise(generator.initial_seed(), shape)).to(dtype)

    monkeypatch.setattr(jflux.sampler_mod, "sample_prior", jax_prior)
    monkeypatch.setattr(jax.random, "normal", jax_prior)
    monkeypatch.setattr(tflux.sampler_mod, "sample_prior", torch_prior)
    return noise


@pytest.fixture(scope="module")
def tokenized_pipelines(quantized_pipelines):
    pipe_j, pipe_t = quantized_pipelines
    for pipe in (pipe_j, pipe_t):
        pipe.t5_tokenizer = _Tokenizer(12, pipe_j.t5_cfg.vocab_size)
        pipe.clip_tokenizer = _Tokenizer(7, pipe_j.clip_cfg.vocab_size)
    return pipe_j, pipe_t


def _assert_protocol_equal(steps_t, steps_j, n_steps):
    steps_t, steps_j = list(steps_t), list(steps_j)
    assert len(steps_t) == len(steps_j) == n_steps + 1
    for a, b in zip(steps_t[0], steps_j[0]):  # the conditioning tuple
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=1e-4)
    for a, b in zip(steps_t[1:], steps_j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    return steps_t


def test_generate_latents_matches_jax(tokenized_pipelines, seeded_noise):
    pipe_j, pipe_t = tokenized_pipelines
    kw = dict(n_images=2, num_steps=3, guidance=4.0, latent_size=(8, 12), seed=7)
    _assert_protocol_equal(pipe_t.generate_latents("a red fox", **kw),
                           pipe_j.generate_latents("a red fox", **kw), 3)


def test_generate_latents_batch_matches_jax(tokenized_pipelines, seeded_noise):
    """One prior per seed (None is seed 0), the prompts' token rows
    concatenated."""
    pipe_j, pipe_t = tokenized_pipelines
    texts, seeds = ["a red fox", "an old lighthouse at dusk", "snow"], [3, None, 11]
    kw = dict(num_steps=2, guidance=4.0, latent_size=(8, 8))
    steps = _assert_protocol_equal(pipe_t.generate_latents_batch(texts, seeds, **kw),
                                   pipe_j.generate_latents_batch(texts, seeds, **kw), 2)
    x_t = steps[0][0]
    assert x_t.shape[0] == 3
    np.testing.assert_array_equal(x_t[1].numpy(), tflux.pack_latents(
        torch.from_numpy(seeded_noise(0, (1, 8, 8, pipe_t.ae_cfg.z_channels))))[0].numpy())
    with pytest.raises(ValueError):
        next(pipe_t.generate_latents_batch(texts, seeds[:2]))


@pytest.mark.parametrize("strength,hw", [(1.0, (32, 32)), (0.5, (32, 32)), (0.2, (32, 32)), (0.5, (1040, 16))],
                         ids=["s1.0", "s0.5", "s0.2", "s0.5_tiled_encode"])
def test_generate_latents_from_image_matches_jax(tokenized_pipelines, seeded_noise, strength, hw):
    """img2img: the start step, noise at ts[start] in the working dtype, the
    remaining steps; a 1040 px side takes the tiled encode (768² tiles,
    overlap 128, in image pixels)."""
    pipe_j, pipe_t = tokenized_pipelines
    image = np.tanh(np.random.default_rng(21).standard_normal((1, *hw, 3))).astype(np.float32)
    kw = dict(n_images=2, strength=strength, num_steps=4, guidance=4.0, seed=5)
    start = min(int(round((1 - strength) * 4)), 3)
    steps = _assert_protocol_equal(pipe_t.generate_latents_from_image(image, "a red fox", **kw),
                                   pipe_j.generate_latents_from_image(image, "a red fox", **kw), 4 - start)
    f = pipe_t.ae_downsample
    assert steps[-1].shape == (2, hw[0] // f * hw[1] // f // 4, 4 * pipe_t.ae_cfg.z_channels)


def test_tiled_encode_runs_above_1024(tokenized_pipelines, monkeypatch):
    """A 1040 px side goes through tiled_decode_2d with the JAX package's
    768 / 128 / 1/f; 1024 px does not."""
    from flux_generator_tpu_torch.ops import tiling

    _, pipe_t = tokenized_pipelines
    calls = []
    real = tiling.tiled_decode_2d
    monkeypatch.setattr(tflux, "tiled_decode_2d",
                        lambda fn, x, **kw: calls.append((tuple(x.shape), kw)) or real(fn, x, **kw))
    pipe_t._encode_image(torch.zeros(1, 1024, 8, 3))
    assert calls == []
    pipe_t._encode_image(torch.zeros(1, 1040, 8, 3))
    assert calls == [((1, 1040, 8, 3), dict(tile=768, overlap=128, factor=1 / pipe_t.ae_downsample))]


def test_generate_images_fused_matches_jax_and_generate_images(tokenized_pipelines, seeded_noise):
    pipe_j, pipe_t = tokenized_pipelines
    kw = dict(num_steps=2, guidance=4.0, latent_size=(8, 8), seed=9)
    seeded_noise.traced_seed = 9
    got = pipe_t.generate_images_fused("a red fox", **kw)
    want = np.asarray(pipe_j.generate_images_fused("a red fox", **kw))
    assert got.dtype == torch.uint8 and got.shape == want.shape == (1, 16, 16, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert torch.equal(got, pipe_t.generate_images("a red fox", as_uint8=True, **kw))


def test_decode_above_128_latents_matches_jax(tokenized_pipelines):
    """Past 128 latent pixels on a side the decode is tiled (96² tiles,
    overlap 16) in both packages."""
    pipe_j, pipe_t = tokenized_pipelines
    h, w = 136, 8
    x = np.random.default_rng(22).standard_normal((1, h * w // 4, 4 * pipe_j.ae_cfg.z_channels)).astype(np.float32)
    want = np.asarray(pipe_j.decode(jnp.asarray(x), (h, w)))
    got = pipe_t.decode(torch.from_numpy(x), (h, w))
    assert got.shape == want.shape == (1, 2 * h, 2 * w, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
