"""The ported SD 2.1 / SDXL-Turbo slice as a whole (CPU, f32, the JAX
package's tiny configs and params): conditioning, the generator methods
(`generate_latents`, `generate_latents_batch`, `generate_latents_from_image`),
`decode` and `decode_u8` of both pipelines against the JAX pipelines' methods
of the same names.

Noise enters both packages from numpy. Each request's draws are numbered:
the JAX package splits the request's key into a prior (or img2img noise) key
and a step key folded with the step index, the port draws the same things in
the same order from one generator seeded with the request's seed; the
coalesced path's priors are each seed's first draw and its ancestral noise a
stream of its own (seeds[0] ^ 0x5EED). `jax.random.normal` and the port's
`sampler.normal` are replaced by functions that hand out the numpy array of
(stream, draw) for the shape asked. The ancestral steps draw inside a jitted
JAX function, so the SDXL runs go through `jax.disable_jit()`.

Latents against JAX at atol 1e-4 and rtol 1e-5 over up to 3 steps (the
tiny random UNet's eps is O(10), so a latent reaches about 25 in the scaled
space: f32 rounding there is 2e-6), images at atol 1e-4, uint8 images within
one level, as tests/test_torch_pipeline_flux.py."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.sd.config import tiny_unet_config as jax_tiny_unet_config
from flux_generator_tpu.models.sd.unet import init_unet as jax_init_unet
from flux_generator_tpu.pipelines import sd as jsd
from flux_generator_tpu_torch.io.params import to_numpy
from flux_generator_tpu_torch.models.clip.text import CLIPTextConfig
from flux_generator_tpu_torch.models.sd import config as tcfg
from flux_generator_tpu_torch.models.sd import sampler as tsmp
from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
from flux_generator_tpu_torch.pipelines import sd as tsd
from tests.test_torch_bridge import REPO, jax_to_torch


class _Tokenizer:
    """Short rows of small ids (the tiny CLIP vocab is 64) with BOS 1 and
    EOS 63, the largest id."""

    eos_token = 63

    def tokenize(self, text):
        return [1] + [3 + (sum(map(ord, w)) % 57) for w in text.split()] + [63]


def _port_pipeline(jpipe):
    """The port's pipeline over the JAX pipeline's params and configs."""
    cls = tsd.StableDiffusionXL if isinstance(jpipe, jsd.StableDiffusionXL) else tsd.StableDiffusion
    return cls(jpipe.model, jax_to_torch(jpipe.params), tcfg.UNetConfig(**dataclasses.asdict(jpipe.unet_cfg)),
               tcfg.AutoencoderConfig(**dataclasses.asdict(jpipe.ae_cfg)),
               [CLIPTextConfig(**dataclasses.asdict(c)) for c in jpipe.clip_cfgs],
               tokenizers=[_Tokenizer()] * len(jpipe.clip_cfgs), dtype=torch.float32)


def _with_tokenizers(jpipe):
    jpipe.tokenizers = [_Tokenizer()] * len(jpipe.clip_cfgs)
    return jpipe


@pytest.fixture(scope="module")
def sd_pipelines():
    pipe_j = _with_tokenizers(jsd.StableDiffusion.random_init(tiny=True, key=jax.random.PRNGKey(1)))
    return pipe_j, _port_pipeline(pipe_j)


@pytest.fixture(scope="module")
def xl_pipelines():
    pipe_j = _with_tokenizers(jsd.StableDiffusionXL.random_init(tiny=True, key=jax.random.PRNGKey(2)))
    return pipe_j, _port_pipeline(pipe_j)


def _key_data(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)).ravel())


class _Draws:
    """numpy noise by (stream, draw index), handed to both packages."""

    def __init__(self):
        self.jax_keys, self.counts, self.generators, self.table = {}, {}, [], {}

    def noise(self, stream, i, shape):
        key = (stream, i, tuple(shape))
        if key not in self.table:
            self.table[key] = np.random.default_rng([stream, i]).standard_normal(shape).astype(np.float32)
        return self.table[key]

    def request(self, seed: int, steps: int):
        """A request's JAX keys: split(PRNGKey(seed)) = (prior or img2img
        noise, step key folded with i) ↔ the port's draws 0 and 1 + i."""
        first, step_key = jax.random.split(jax.random.PRNGKey(seed))
        self.jax_keys[_key_data(first)] = (seed, 0)
        for i in range(steps):
            self.jax_keys[_key_data(jax.random.fold_in(step_key, i))] = (seed, 1 + i)

    def stream(self, seed: int, steps: int):
        """The coalesced path's step stream: fold_in(PRNGKey(seed), i) ↔ draw i."""
        for i in range(steps):
            self.jax_keys[_key_data(jax.random.fold_in(jax.random.PRNGKey(seed), i))] = (seed, i)

    def jax_normal(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(self.noise(*self.jax_keys[_key_data(key)], shape), dtype)

    def torch_normal(self, generator, shape, dtype=torch.float32):
        i = self.counts.get(id(generator), 0)
        self.counts[id(generator)] = i + 1
        self.generators.append(generator)  # keeps each id unique for the test's life
        return torch.from_numpy(self.noise(generator.initial_seed(), i, shape)).to(dtype)


@pytest.fixture
def draws(monkeypatch):
    d = _Draws()
    monkeypatch.setattr(jax.random, "normal", d.jax_normal)
    monkeypatch.setattr(tsmp, "normal", d.torch_normal)
    return d


def _assert_steps_equal(steps_t, steps_j, n):
    steps_t, steps_j = list(steps_t), list(steps_j)
    assert len(steps_t) == len(steps_j) == n
    for a, b in zip(steps_t, steps_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    return steps_t, steps_j


def _assert_images_equal(pipe_t, pipe_j, lat_t, lat_j):
    img_t, img_j = pipe_t.decode(lat_t), pipe_j.decode(lat_j)
    assert img_t.shape == img_j.shape
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    u8_t, u8_j = pipe_t.decode_u8(lat_t).numpy(), np.asarray(pipe_j.decode_u8(lat_j))
    assert u8_t.dtype == np.uint8 and u8_t.shape == u8_j.shape
    assert np.abs(u8_t.astype(int) - u8_j.astype(int)).max() <= 1


# ------------------------------------------------------------ conditioning


@pytest.mark.parametrize("cfg_weight,n_images", [(7.5, 2), (1.0, 1)])
def test_sd_conditioning_matches_jax(sd_pipelines, cfg_weight, n_images):
    """The prompt's rows, then the negative prompt's under CFG, each
    n_images times, padded to the model's max_length; atol 1e-5."""
    pipe_j, pipe_t = sd_pipelines
    want = pipe_j.get_text_conditioning("a red fox", n_images, cfg_weight, "blurry")
    got = pipe_t.get_text_conditioning("a red fox", n_images, cfg_weight, "blurry")
    assert got.shape == (n_images * (2 if cfg_weight > 1 else 1), 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cfg_weight,n_images", [(0.0, 2), (3.0, 1)])
def test_sdxl_conditioning_matches_jax(xl_pipelines, cfg_weight, n_images):
    """Both encoders' second to last hidden states concatenated, and the
    second's projected pooled output; atol 1e-5."""
    pipe_j, pipe_t = xl_pipelines
    cond_j, pooled_j = pipe_j.get_text_conditioning("a red fox", n_images, cfg_weight, "blurry")
    cond_t, pooled_t = pipe_t.get_text_conditioning("a red fox", n_images, cfg_weight, "blurry")
    assert cond_t.shape == (n_images * (2 if cfg_weight > 1 else 1), 16, 16) and pooled_t.shape[-1] == 8
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-5)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j), atol=1e-5)
    pooled, time_ids = pipe_t._text_time_for((cond_t, pooled_t), n_images)
    np.testing.assert_array_equal(time_ids.numpy(),
                                  np.asarray(pipe_j._text_time_for((cond_j, pooled_j), n_images)[1]))


def test_long_prompts_are_cut_with_eos_as_in_jax(sd_pipelines):
    pipe_j, pipe_t = sd_pipelines
    text = " ".join(f"w{i}" for i in range(30))
    want = np.asarray(pipe_j._tokenize(pipe_j.tokenizers[0], text, "short"))
    got = pipe_t._tokenize(pipe_t.tokenizers[0], text, "short")
    assert got.dtype == torch.long and got.shape == (2, 16) and got[0, -1].item() == 63
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ SD 2.1: Euler


@pytest.mark.parametrize("cfg_weight", [7.5, 0.0])
def test_sd_generate_latents_matches_jax(sd_pipelines, draws, cfg_weight):
    pipe_j, pipe_t = sd_pipelines
    draws.request(7, 0)
    kw = dict(n_images=2, num_steps=3, cfg_weight=cfg_weight, negative_text="dull", latent_size=(8, 12), seed=7)
    steps_t, steps_j = _assert_steps_equal(pipe_t.generate_latents("a red fox", **kw),
                                           pipe_j.generate_latents("a red fox", **kw), 3)
    assert steps_t[-1].shape == (2, 8, 12, 4)
    _assert_images_equal(pipe_t, pipe_j, steps_t[-1], steps_j[-1])


def test_sd_generate_latents_batch_matches_jax(sd_pipelines, draws):
    """The coalescer's path, CFG on, prompts of different lengths; and each
    item equals its seed's solo run (Euler), as in the JAX package."""
    pipe_j, pipe_t = sd_pipelines
    texts, seeds = ["a cat", "a very fluffy dog in a tiny red hat"], [3, 9]
    for s in seeds:
        draws.request(s, 0)
    kw = dict(num_steps=2, cfg_weight=7.5, negative_text="dull", latent_size=(8, 8))
    steps_t, _ = _assert_steps_equal(pipe_t.generate_latents_batch(texts, seeds, **kw),
                                     pipe_j.generate_latents_batch(texts, seeds, **kw), 2)
    for i, (text, seed) in enumerate(zip(texts, seeds)):
        solo = list(pipe_t.generate_latents(text, seed=seed, **kw))[-1]
        np.testing.assert_allclose(steps_t[-1][i:i + 1].numpy(), solo.numpy(), atol=1e-5)


def test_sd_img2img_matches_jax(sd_pipelines, draws):
    """strength 0.5 of 4 steps: the encode, noise at t = 500, 2 steps."""
    pipe_j, pipe_t = sd_pipelines
    draws.request(5, 0)
    image = np.random.default_rng(20).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    kw = dict(n_images=2, strength=0.5, num_steps=4, cfg_weight=7.5, seed=5)
    trace = {}
    steps_t, steps_j = _assert_steps_equal(pipe_t.generate_latents_from_image(image, "a red fox", trace=trace, **kw),
                                           pipe_j.generate_latents_from_image(jnp.asarray(image), "a red fox", **kw),
                                           2)
    assert set(trace) == {"conditioning_s", "encode_s"}
    _assert_images_equal(pipe_t, pipe_j, steps_t[-1], steps_j[-1])


def test_sd_denoise_matches_the_generator(sd_pipelines, draws):
    """`denoise` (the whole schedule) ends where generate_latents ends."""
    _, pipe_t = sd_pipelines
    draws.request(4, 0)
    last = list(pipe_t.generate_latents("a cat", num_steps=3, cfg_weight=7.5, latent_size=(8, 8), seed=4))[-1]
    cond = pipe_t.get_text_conditioning("a cat", 1, 7.5, "")
    x_T = torch.from_numpy(draws.noise(4, 0, (1, 8, 8, 4)))
    x_T = x_T * float(pipe_t.sigmas[-1]) / float(np.sqrt(pipe_t.sigmas[-1] ** 2 + 1))
    np.testing.assert_allclose(pipe_t.denoise(x_T, cond, 3, 7.5).numpy(), last.numpy(), atol=1e-6)


def _fake_vae(xp, f):
    """A stand-in decoder and encoder, in numpy-like `xp` (jnp or torch):
    nearest up- or down-sampling by f plus a ramp over each call's own
    rows, so that where the tiles lie and how their overlaps blend shows in
    the output."""
    def ramp(n, like):
        return (xp.arange(n) * 0.01).reshape(1, n, 1, 1).astype(like.dtype) if xp is jnp else \
            (torch.arange(n, dtype=like.dtype) * 0.01).reshape(1, n, 1, 1)

    def decode(params, cfg, z):
        img = z[..., :3]
        if xp is jnp:
            img = jnp.repeat(jnp.repeat(img, f, axis=1), f, axis=2)
        else:
            img = img.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
        return img + ramp(img.shape[1], img)

    def encode(params, cfg, x):
        b, h, w, _ = x.shape
        m = x[:, ::f, ::f, :1] + x[:, ::f, ::f, 1:2]
        m = (jnp.concatenate if xp is jnp else torch.cat)([m, m, x[:, ::f, ::f, :2]], -1)
        m = m + ramp(h // f, m)
        return m, m

    return decode, encode


def test_sd_tiled_decode_and_encode_match_jax(sd_pipelines, monkeypatch):
    """Past the untiled sizes, with a stand-in VAE on both sides: a 136²
    latent's decode in four 96² tiles (overlap 16) and a 1040 px image's
    encode in four 768² tiles (overlap 128); atol 1e-5."""
    pipe_j, pipe_t = sd_pipelines
    f = pipe_t._factor()
    calls = []
    dec_j, enc_j = _fake_vae(jnp, f)
    dec_t, enc_t = _fake_vae(torch, f)
    monkeypatch.setattr(jsd, "sd_vae_decode", dec_j)
    monkeypatch.setattr(jsd, "sd_vae_encode", enc_j)
    monkeypatch.setattr(tsd, "sd_vae_decode", lambda p, c, z: calls.append(z.shape[1:3]) or dec_t(p, c, z))
    monkeypatch.setattr(tsd, "sd_vae_encode", lambda p, c, x: calls.append(x.shape[1:3]) or enc_t(p, c, x))
    z = np.random.default_rng(21).standard_normal((1, 136, 136, 4)).astype(np.float32)
    got = pipe_t.decode(torch.from_numpy(z))
    assert got.shape == (1, 136 * f, 136 * f, 3) and calls == [(96, 96)] * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(pipe_j.decode(jnp.asarray(z))), atol=1e-5)
    image = np.random.default_rng(22).uniform(-1, 1, (1, 1040, 1040, 3)).astype(np.float32)
    got = pipe_t._encode(torch.from_numpy(image))
    want = pipe_j._encode(pipe_j.params["vae"], jnp.asarray(image))
    assert got.shape == (1, 1040 // f, 1040 // f, 4) and calls[4:] == [(768, 768)] * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------ SDXL: Euler-ancestral


def test_sdxl_generate_latents_matches_jax(xl_pipelines, draws):
    """The ancestral sampler with the step noise injected, under CFG with
    two images (the coalesced and img2img cases below run the Turbo default,
    no CFG)."""
    pipe_j, pipe_t = xl_pipelines
    draws.request(11, 2)
    kw = dict(n_images=2, num_steps=2, cfg_weight=3.0, negative_text="dull", latent_size=(8, 8), seed=11)
    with jax.disable_jit():
        want = list(pipe_j.generate_latents("a red fox", **kw))
    steps_t, _ = _assert_steps_equal(pipe_t.generate_latents("a red fox", **kw), want, 2)
    with jax.disable_jit():
        _assert_images_equal(pipe_t, pipe_j, steps_t[-1], want[-1])


def test_sdxl_generate_latents_batch_matches_jax(xl_pipelines, draws):
    pipe_j, pipe_t = xl_pipelines
    texts, seeds = ["a cat", "a dog on a beach", "a boat"], [3, 4, 5]
    for s in seeds:
        draws.request(s, 0)
    draws.stream(3 ^ 0x5EED, 2)
    kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8))
    with jax.disable_jit():
        want = list(pipe_j.generate_latents_batch(texts, seeds, **kw))
    steps_t, _ = _assert_steps_equal(pipe_t.generate_latents_batch(texts, seeds, **kw), want, 2)
    assert steps_t[-1].shape == (3, 8, 8, 4)


def test_sdxl_img2img_matches_jax(xl_pipelines, draws):
    """The Turbo defaults (2 steps, no CFG) at strength 0.5: one step."""
    pipe_j, pipe_t = xl_pipelines
    draws.request(6, 1)
    image = np.random.default_rng(23).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    with jax.disable_jit():
        want = list(pipe_j.generate_latents_from_image(jnp.asarray(image), "a red fox", strength=0.5, seed=6))
    _assert_steps_equal(pipe_t.generate_latents_from_image(image, "a red fox", strength=0.5, seed=6), want, 1)


# ------------------------------------------------------------ kernel A's route, construction


def test_pipeline_with_kernel_a_route_matches_jax(request, monkeypatch):
    """A UNet whose level 0 has one head of 64 at a 16x16 latent: 256-token
    self-attention, which takes kernel A (its plain version here) in the port
    and XLA's attention in the JAX package on the CPU; CFG's 2x batch, 2
    steps, one A call a step."""
    cfg = jax_tiny_unet_config(block_out_channels=(64, 64), num_attention_heads=(1, 1), norm_num_groups=8)
    base = jsd.StableDiffusion.random_init(tiny=True, key=jax.random.PRNGKey(3))
    params = dict(base.params, unet=jax_init_unet(jax.random.PRNGKey(4), cfg))
    pipe_j = _with_tokenizers(jsd.StableDiffusion(base.model, params, cfg, base.ae_cfg, base.clip_cfgs,
                                                  dtype=jnp.float32))
    pipe_t = _port_pipeline(pipe_j)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, int8="": calls.append(tuple(q.shape) + (int8,)) or real(q, k, v, int8=int8))
    request.getfixturevalue("draws").request(8, 0)  # after the JAX init, which draws normals
    kw = dict(num_steps=2, cfg_weight=4.0, latent_size=(16, 16), seed=8)
    _assert_steps_equal(pipe_t.generate_latents("a red fox", **kw), pipe_j.generate_latents("a red fox", **kw), 2)
    assert calls == [(2, 256, 1, 64, "")] * 2


def test_random_init_tiny_configs_match_jax():
    for tcls, jcls in ((tsd.StableDiffusion, jsd.StableDiffusion), (tsd.StableDiffusionXL, jsd.StableDiffusionXL)):
        pipe_t = tcls.random_init(tiny=True, device="cpu", dtype=torch.float32)
        pipe_j = jcls.random_init(tiny=True)
        assert dataclasses.asdict(pipe_t.unet_cfg) == dataclasses.asdict(pipe_j.unet_cfg)
        assert dataclasses.asdict(pipe_t.ae_cfg) == dataclasses.asdict(pipe_j.ae_cfg)
        assert [dataclasses.asdict(c) for c in pipe_t.clip_cfgs] == [dataclasses.asdict(c) for c in pipe_j.clip_cfgs]
        got, want = to_numpy(pipe_t.params), jax.tree.map(np.asarray, pipe_j.params)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == [b.shape for b in jax.tree.leaves(want)]
        assert pipe_t.device == torch.device("cpu") and pipe_t.ancestral == pipe_j.ancestral


def test_random_init_is_seeded_and_needs_a_card_by_default():
    a = tsd.StableDiffusionXL.random_init(tiny=True, dtype=torch.float32, generator=torch.Generator().manual_seed(5))
    b = tsd.StableDiffusionXL.random_init(tiny=True, dtype=torch.float32, generator=torch.Generator().manual_seed(5))
    for x, y in zip(jax.tree.leaves(to_numpy(a.params)), jax.tree.leaves(to_numpy(b.params))):
        np.testing.assert_array_equal(x, y)
    assert a.model == "stabilityai/sdxl-turbo"
    assert tsd.StableDiffusion.default_model == "stabilityai/stable-diffusion-2-1-base"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsd.StableDiffusion.random_init()
    with pytest.raises(ValueError, match="not a StableDiffusion"):
        tsd.StableDiffusion.random_init("sdxl-turbo", device="cpu")
    with pytest.raises(ValueError, match="not a StableDiffusionXL"):
        tsd.StableDiffusionXL.random_init("stable-diffusion-2-1-base", device="cpu")


def test_sd_pipelines_load_nothing_of_the_jax_package():
    """Build tiny SD and SDXL pipelines on the CPU and run a request of each
    with the decode, in a fresh process: no jax and no module of the JAX
    package is imported."""
    code = (
        "import sys, torch\n"
        "from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL\n"
        "class Tok:\n"
        "    eos_token = 63\n"
        "    def tokenize(self, text):\n"
        "        return [1, 5, 9, 63]\n"
        "for cls, cfg in ((StableDiffusion, 7.5), (StableDiffusionXL, 0.0)):\n"
        "    pipe = cls.random_init(tiny=True, device='cpu', dtype=torch.float32)\n"
        "    pipe.tokenizers = [Tok(), Tok()]\n"
        "    lat = list(pipe.generate_latents_batch(['a', 'b'], [1, 2], num_steps=2, cfg_weight=cfg, "
        "latent_size=(8, 8)))[-1]\n"
        "    assert pipe.decode_u8(lat).shape == (2, 16, 16, 3)\n"
        "loaded = [m for m in sys.modules if m in ('jax', 'flux_generator_tpu') "
        "or m.startswith(('jax.', 'flux_generator_tpu.'))]\n"
        "assert not loaded, loaded\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
