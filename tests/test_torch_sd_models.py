"""The port's SD modules against the JAX package's (CPU, f32 unless a test
says otherwise): configs and the registry, the samplers (the ancestral step
and add_noise with the noise injected), the time embedding with and without
SDXL's text_time, the UNet (with self-attention long enough for kernel A's
route, taken by its plain version here), the VAE, CLIP's hidden states, and
the parameter bridge for the UNet and VAE trees."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.clip import text as jclip
from flux_generator_tpu.models.sd import config as jcfg
from flux_generator_tpu.models.sd import sampler as jsmp
from flux_generator_tpu.models.sd import unet as junet
from flux_generator_tpu.models.sd import vae as jvae
from flux_generator_tpu_torch.io import registry
from flux_generator_tpu_torch.io.params import to_numpy, to_torch
from flux_generator_tpu_torch.models.clip import text as tclip
from flux_generator_tpu_torch.models.sd import config as tcfg
from flux_generator_tpu_torch.models.sd import sampler as tsmp
from flux_generator_tpu_torch.models.sd import unet as tunet
from flux_generator_tpu_torch.models.sd import vae as tvae
from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
from tests.test_torch_bridge import jax_to_torch


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_cfg(cfg):
    """The JAX package's config class with the port config's fields."""
    cls = {tcfg.UNetConfig: jcfg.UNetConfig, tcfg.AutoencoderConfig: jcfg.AutoencoderConfig,
           tclip.CLIPTextConfig: jclip.CLIPTextConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("name", ["UNetConfig", "AutoencoderConfig", "DiffusionConfig"])
def test_config_defaults_match_jax(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())


def test_tiny_configs_match_jax():
    assert dataclasses.asdict(tcfg.tiny_unet_config()) == dataclasses.asdict(jcfg.tiny_unet_config())
    assert dataclasses.asdict(tcfg.tiny_sd_ae_config()) == dataclasses.asdict(jcfg.tiny_sd_ae_config())
    assert tcfg.UNetConfig().temb_dim == jcfg.UNetConfig().temb_dim == 1280


# Parameter counts of the diffusers / transformers models of each repo
# (UNet2DConditionModel, AutoencoderKL, CLIPTextModel[WithProjection]); the
# JAX tree of the port's config holds the same number, counted without
# allocating (jax.eval_shape).
PUBLISHED_COUNTS = {
    "stable-diffusion-2-1-base": (865_910_724, 83_653_863, (340_387_840,)),
    "sdxl-turbo": (2_567_463_684, 83_653_863, (123_060_480, 694_659_840)),
}


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", sorted(PUBLISHED_COUNTS))
def test_registry_configs_have_the_published_sizes(name):
    unet_cfg, ae_cfg, clip_cfgs = registry.sd_configs(name)
    assert registry.sd_configs(registry.SD_MODELS[name]["repo_id"]) == (unet_cfg, ae_cfg, clip_cfgs)
    key = jax.random.PRNGKey(0)
    unet_n, vae_n, clip_n = PUBLISHED_COUNTS[name]
    assert _count(jax.eval_shape(lambda: junet.init_unet(key, _jax_cfg(unet_cfg)))) == unet_n
    assert _count(jax.eval_shape(lambda: jvae.init_sd_vae(key, _jax_cfg(ae_cfg)))) == vae_n
    assert tuple(_count(jax.eval_shape(lambda c=c: jclip.init_clip_text(key, _jax_cfg(c))))
                 for c in clip_cfgs) == clip_n


def test_registry_scaling_factors_and_layouts():
    sd_unet, sd_vae, (sd_clip,) = registry.sd_configs("stable-diffusion-2-1-base")
    xl_unet, xl_vae, (clip_l, clip_g) = registry.sd_configs("sdxl-turbo")
    assert (sd_vae.scaling_factor, xl_vae.scaling_factor) == (0.18215, 0.13025)
    # Hugging Face's deepest-first up_block_types, reversed into levels (io/loaders.py:273)
    assert sd_unet.up_block_types[::-1] == ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3
    assert xl_unet.up_block_types[::-1] == ("CrossAttnUpBlock2D",) * 2 + ("UpBlock2D",)
    assert (sd_clip.num_layers, sd_clip.model_dims, sd_clip.hidden_act) == (23, 1024, "gelu")
    assert (clip_l.num_layers, clip_l.model_dims, clip_l.hidden_act) == (12, 768, "quick_gelu")
    assert (clip_g.num_layers, clip_g.num_heads, clip_g.projection_dim) == (32, 20, 1280)
    assert xl_unet.cross_attention_dim[0] == clip_l.model_dims + clip_g.model_dims
    # every head is 64 wide: kernel A's head dim
    for cfg in (sd_unet, xl_unet):
        assert {c // h for c, h in zip(cfg.block_out_channels, cfg.num_attention_heads)} == {64}
    with pytest.raises(KeyError):
        registry.sd_configs("stable-diffusion-1-5")


# ------------------------------------------------------------ samplers


def test_sigmas_and_timesteps_match_jax():
    for cfg in (tcfg.DiffusionConfig(), tcfg.DiffusionConfig(beta_schedule="linear")):
        want = jsmp.make_sigmas(jcfg.DiffusionConfig(**dataclasses.asdict(cfg)))
        np.testing.assert_array_equal(tsmp.make_sigmas(cfg), want)
    sigmas = jsmp.make_sigmas(jcfg.DiffusionConfig())
    assert tsmp.max_time(sigmas) == jsmp.max_time(sigmas) == 1000
    for n, start in ((50, None), (2, None), (25, 500.0), (1, 300.5)):
        np.testing.assert_array_equal(tsmp.timesteps(sigmas, n, start), jsmp.timesteps(sigmas, n, start))


@pytest.mark.parametrize("t", [0.0, 1.0, 0.25, 333.7, 999.5, 1000.0])
def test_interp_sigma_matches_jax(t):
    sigmas = jsmp.make_sigmas(jcfg.DiffusionConfig())
    want = np.asarray(jsmp.interp_sigma(sigmas, t))
    got = tsmp.interp_sigma(torch.from_numpy(sigmas), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# bf16 steps: one bf16 ulp (2^-8 relative) apart at most, from XLA and
# torch rounding intermediate products differently; f32 to 1e-6
STEP_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6), torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _step_inputs(dtype):
    eps, x, noise = _rand(1, 2, 8, 8, 4), _rand(2, 2, 8, 8, 4), _rand(3, 2, 8, 8, 4)
    return ([torch.from_numpy(a).to(dtype) for a in (eps, x, noise)],
            [jnp.asarray(a, _JNP[dtype]) for a in (eps, x, noise)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,t_prev", [(999.0, 979.0), (500.0, 0.0), (20.4, 0.0), (999.0, 499.5)])
def test_euler_steps_match_jax(dtype, t, t_prev, monkeypatch):
    """euler_step, and euler_ancestral_step with its noise injected into the
    JAX function's draw."""
    sigmas = jsmp.make_sigmas(jcfg.DiffusionConfig())
    (eps_t, x_t, noise_t), (eps_j, x_j, noise_j) = _step_inputs(dtype)
    s = torch.from_numpy(sigmas)
    tt, tp = torch.tensor(t), torch.tensor(t_prev)
    got = tsmp.euler_step(s, eps_t, x_t, tt, tp)
    want = jsmp.euler_step(sigmas, eps_j, x_j, jnp.float32(t), jnp.float32(t_prev))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **STEP_TOL[dtype])

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dt=jnp.float32: noise_j.astype(dt))
    got = tsmp.euler_ancestral_step(noise_t, s, eps_t, x_t, tt, tp)
    want = jsmp.euler_ancestral_step(jax.random.PRNGKey(0), sigmas, eps_j, x_j, jnp.float32(t),
                                     jnp.float32(t_prev))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **STEP_TOL[dtype])
    # the noise enters: another draw moves the result unless σ_up is 0 (t_prev 0)
    other = tsmp.euler_ancestral_step(-noise_t, s, eps_t, x_t, tt, tp)
    assert torch.equal(other, got) == (t_prev == 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prior_and_add_noise_match_jax(dtype, monkeypatch):
    sigmas = jsmp.make_sigmas(jcfg.DiffusionConfig())
    (_, x_t, noise_t), (_, x_j, noise_j) = _step_inputs(dtype)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dt=jnp.float32: noise_j.astype(dt))
    monkeypatch.setattr(tsmp, "normal", lambda generator, shape, dt=torch.float32: noise_t.to(dt))
    g = torch.Generator()
    got = tsmp.sample_prior(g, sigmas, (2, 8, 8, 4), dtype)
    want = jsmp.sample_prior(jax.random.PRNGKey(0), sigmas, (2, 8, 8, 4), _JNP[dtype])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **STEP_TOL[dtype])
    for t in (500.0, 137.25):
        got = tsmp.add_noise(noise_t, torch.from_numpy(sigmas), x_t, t)
        want = jsmp.add_noise(jax.random.PRNGKey(0), sigmas, x_j, jnp.asarray(t))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **STEP_TOL[dtype])


def test_normal_draws_from_the_generator():
    a = tsmp.normal(torch.Generator().manual_seed(3), (4, 5), torch.bfloat16)
    b = tsmp.normal(torch.Generator().manual_seed(3), (4, 5), torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ------------------------------------------------------------ UNet


SDXL_TINY = dict(addition_embed_type="text_time", addition_time_embed_dim=8,
                 projection_class_embeddings_input_dim=8 + 6 * 8)


@functools.lru_cache(maxsize=None)
def _jax_unet_params(cfg_j):
    """JAX UNet params of a config (eager: each config's jit compile costs
    more here than the op-by-op run), made once."""
    return junet.init_unet(jax.random.PRNGKey(3), cfg_j)


def _unet_pair(**overrides):
    cfg_j = jcfg.tiny_unet_config(**overrides)
    params = _jax_unet_params(cfg_j)
    return cfg_j, tcfg.tiny_unet_config(**overrides), params, jax_to_torch(params)


@pytest.mark.parametrize("text_time", [False, True])
def test_compute_temb_matches_jax(text_time):
    """atol 1e-5: f32 sinusoids and two small dense layers."""
    overrides = SDXL_TINY if text_time else {}
    cfg_j, cfg_t, pj, pt = _unet_pair(**overrides)
    ts = np.array([999.0, 0.5, 417.25], np.float32)
    tt_j = tt_t = None
    if text_time:
        pooled = _rand(4, 3, 8)
        ids = np.array([[512, 512, 0, 0, 512, 512], [1024, 768, 16, 8, 1024, 1024], [0] * 6], np.float32)
        tt_j = (jnp.asarray(pooled), jnp.asarray(ids))
        tt_t = (torch.from_numpy(pooled), torch.from_numpy(ids))
    want = junet.compute_temb(pj, cfg_j, jnp.asarray(ts), tt_j, jnp.float32)
    got = tunet.compute_temb(pt, cfg_t, torch.from_numpy(ts), tt_t, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if text_time:  # the added embedding is live
        plain = tunet.compute_temb(pt, cfg_t, torch.from_numpy(ts), None, torch.float32)
        assert (plain - got).abs().max().item() > 1e-3


@pytest.mark.parametrize("text_time", [False, True])
def test_unet_forward_matches_jax(text_time):
    """The tiny config (two levels, self-attention of 16 or 64 tokens: the
    plain attention), with and without text_time; atol 1e-4."""
    overrides = SDXL_TINY if text_time else {}
    cfg_j, cfg_t, pj, pt = _unet_pair(**overrides)
    x, ctx = _rand(5, 2, 8, 8, 4), _rand(6, 2, 7, 16)
    ts = np.array([999.0, 20.5], np.float32)
    tt_j = tt_t = None
    if text_time:
        pooled, ids = _rand(7, 2, 8), np.tile(np.array([512, 512, 0, 0, 512, 512], np.float32), (2, 1))
        tt_j, tt_t = (jnp.asarray(pooled), jnp.asarray(ids)), (torch.from_numpy(pooled), torch.from_numpy(ids))
    want = jax.jit(lambda p, a, b, c, d: junet.unet_forward(p, cfg_j, a, b, c, d))(
        pj, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), tt_j)
    got = tunet.unet_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx), tt_t)
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("pallas", [False, True])
def test_unet_forward_with_kernel_a_route_matches_jax(pallas, monkeypatch):
    """Level 0 at 16x16 latents is a 256-token self-attention with one head
    of 64: the JAX package sends it to its flash kernel (run in interpret
    mode here) when Pallas attention is on, and to XLA's attention when it
    is off; the port sends it to kernel A, whose plain version runs on CPU
    tensors (one call a UNet forward, counted). atol 1e-4."""
    import functools
    import importlib

    jattn = importlib.import_module("flux_generator_tpu.ops.pallas.flash_attention")
    overrides = dict(block_out_channels=(64, 64), num_attention_heads=(1, 1), norm_num_groups=8)
    cfg_j, cfg_t, pj, pt = _unet_pair(**overrides)
    x, ctx = _rand(9, 2, 16, 16, 4), _rand(10, 2, 5, 16)
    ts = np.array([700.0, 3.0], np.float32)
    monkeypatch.setenv("FGT_PALLAS_ATTENTION", "1" if pallas else "0")
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(jattn.flash_attention, interpret=True))
    want = junet.unet_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))

    calls = []
    real = fa.flash_attention

    def counting(q, k, v, *args, **kwargs):
        calls.append(tuple(q.shape))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", counting)
    got = tunet.unet_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    assert calls == [(2, 256, 1, 64)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# A UNet call at a 64x64 latent (512²) in each model's layout, narrowed to
# one head of 64 a level: the self-attentions that reach kernel A by (L,
# calls). SD 2.1-base: 2 + 3 sites at 64², 32² and 16² (the 8x8 mid block
# stays plain); SDXL-Turbo: levels 1 and 2 with 2 and 10 blocks a site, and
# the mid block's 10 at 16².
A_CALLS = {
    "stable-diffusion-2-1-base": {4096: 5, 1024: 5, 256: 5},
    "sdxl-turbo": {1024: 10, 256: 60},
}


@pytest.mark.parametrize("name", sorted(A_CALLS))
def test_self_attention_reaches_kernel_a_as_in_jax(name, monkeypatch):
    """Kernel A's calls a UNet call, at the full layout of each model
    (narrow channels, head dim 64): 15 for SD 2.1-base, 70 for SDXL-Turbo."""
    full, _, _ = registry.sd_configs(name)
    n = len(full.block_out_channels)
    cfg = dataclasses.replace(full, block_out_channels=(64,) * n, num_attention_heads=(1,) * n,
                              cross_attention_dim=(16,) * n, norm_num_groups=8,
                              addition_time_embed_dim=8 if full.addition_embed_type else None,
                              projection_class_embeddings_input_dim=8 + 6 * 8 if full.addition_embed_type else None)
    params = tunet.init_unet(torch.Generator().manual_seed(1), cfg)
    calls, tiers = [], []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, int8="": calls.append(q.shape[1]) or tiers.append(int8) or torch.zeros_like(q))
    x, ctx = torch.zeros(1, 64, 64, 4), torch.zeros(1, 77, 16)
    tt = (torch.zeros(1, 8), torch.zeros(1, 6)) if full.addition_embed_type else None
    out = tunet.unet_forward(params, cfg, x, torch.tensor([999.0]), ctx, tt)
    assert out.shape == (1, 64, 64, 4)
    assert {length: calls.count(length) for length in set(calls)} == A_CALLS[name]
    assert len(calls) == (15 if name == "stable-diffusion-2-1-base" else 70)
    assert set(tiers) == {""}  # no int8 tier unless the caller asks for one


# ------------------------------------------------------------ VAE and CLIP


def test_vae_encode_decode_match_jax():
    """atol 1e-4 on the encoder's mean and logvar and the decoder's image."""
    cfg_j, cfg_t = jcfg.tiny_sd_ae_config(), tcfg.tiny_sd_ae_config()
    pj = jvae.init_sd_vae(jax.random.PRNGKey(11), cfg_j)
    pt = jax_to_torch(pj)
    img = _rand(12, 2, 16, 24, 3)
    mean_j, logvar_j = jvae.sd_vae_encode(pj, cfg_j, jnp.asarray(img))
    mean_t, logvar_t = tvae.sd_vae_encode(pt, cfg_t, torch.from_numpy(img))
    assert mean_t.shape == (2, 8, 12, 4)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-4)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j), atol=1e-4)
    z = _rand(13, 2, 8, 12, 4)
    want = jvae.sd_vae_decode(pj, cfg_j, jnp.asarray(z))
    got = tvae.sd_vae_decode(pt, cfg_t, torch.from_numpy(z))
    assert got.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("projection", [None, 8])
def test_clip_hidden_states_match_jax(projection):
    """Every layer's output before the final LayerNorm (SDXL takes [-2]),
    atol 1e-5, beside the outputs the Flux path reads."""
    cfg_j = jclip.tiny_clip_config(num_layers=3, projection_dim=projection, hidden_act="gelu")
    cfg_t = tclip.tiny_clip_config(num_layers=3, projection_dim=projection, hidden_act="gelu")
    params = jclip.init_clip_text(jax.random.PRNGKey(14), cfg_j)
    toks = np.random.default_rng(15).integers(1, cfg_j.vocab_size - 1, (2, 16)).astype(np.int32)
    toks[:, 9] = cfg_j.vocab_size - 1
    toks[:, 10:] = 0  # the SD pipelines pad with 0 after EOS
    want = jclip.clip_text_forward(params, cfg_j, jnp.asarray(toks))
    got = tclip.clip_text_forward(jax_to_torch(params), cfg_t, torch.from_numpy(toks).long())
    assert set(got) == {"last_hidden_state", "pooled_output", "hidden_states"}
    assert len(got["hidden_states"]) == 3 and all(h.shape == (2, 16, 32) for h in got["hidden_states"])
    for key in ("last_hidden_state", "pooled_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)
    for got_h, want_h in zip(got["hidden_states"], np.asarray(want["hidden_states"])):
        np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-5)


@pytest.mark.parametrize("which", ["unet", "unet_text_time", "vae"])
def test_sd_trees_round_trip_exactly(which):
    """The JAX UNet tree (lists of levels and resnets, stacked transformer
    blocks) and VAE tree, in bf16, survive JAX → torch → numpy bit for bit."""
    if which == "vae":
        tree = jvae.init_sd_vae(jax.random.PRNGKey(16), jcfg.tiny_sd_ae_config())
    else:
        tree = _jax_unet_params(jcfg.tiny_unet_config(
            transformer_layers_per_block=(2, 3), **(SDXL_TINY if which == "unet_text_time" else {})))
    tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    want = jax.tree.map(np.asarray, tree)
    got = to_numpy(to_torch(want))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    if which != "vae":
        blocks = to_torch(want)["down_blocks"][0]["attentions"][0]["blocks"]
        assert blocks["attn1"]["q"]["kernel"].shape[0] == 2  # stacked on a leading axis


def test_init_unet_layout_matches_jax():
    """The port's random init builds the JAX tree's structure and shapes."""
    for overrides in ({}, SDXL_TINY, dict(transformer_layers_per_block=(2, 3))):
        want = jax.eval_shape(lambda: junet.init_unet(jax.random.PRNGKey(0), jcfg.tiny_unet_config(**overrides)))
        got = to_numpy(tunet.init_unet(torch.Generator().manual_seed(0), tcfg.tiny_unet_config(**overrides)))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == [tuple(b.shape) for b in jax.tree.leaves(want)]
    want = jax.eval_shape(lambda: jvae.init_sd_vae(jax.random.PRNGKey(0), jcfg.tiny_sd_ae_config()))
    got = to_numpy(tvae.init_sd_vae(torch.Generator().manual_seed(0), tcfg.tiny_sd_ae_config()))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == [tuple(b.shape) for b in jax.tree.leaves(want)]
