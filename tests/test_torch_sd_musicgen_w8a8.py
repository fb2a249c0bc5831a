"""The W8A8 route and SD's int8 attention tier in the SD and MusicGen paths
(CPU, f32, int8 per-channel weights): the port's `w8a8=` route against the
JAX package under its process-wide `set_w8a8(True)` with the matching
FGT_W8A8_IMPL ("ops" ↔ "xla", "rows" ↔ "pq", "fused" ↔ "pallas", its Pallas
kernels in interpret mode), and SD's `attn_int8` tiers against the JAX
package under `set_attn_int8` with its Pallas flash attention (interpret
mode): the UNet, a StableDiffusion pipeline, MusicGen's T5 and `text_proj`
and its plain decode step. Shapes are chosen so that every route takes its
kernel's formulation: K a multiple of 128 and 16 rows or more.

How W8A8 is compared. A dense layer under W8A8 agrees with the JAX one to
f32 rounding (tests/test_torch_w8a8.py), but an activation a few ulps apart
can round to the other int8 level, and every later layer then quantizes a
slightly different row: over a UNet the two runs drift apart by the size of
the W8A8 error itself (0.9% rel-L2 measured here, in f64 too, against 1.1%
for weight-only), so a whole-network comparison cannot tell a right route
from none. So each network is held to JAX's layer by layer: the dense
layers that take int8 activations are the same ones as JAX's under its
switch (by kernel and activation shape, JAX's traced), and every such call
of the port's run, on its own inputs, equals JAX's `dense` under the switch
to 1e-6 of max|y|. MusicGen's conditioning (two T5 layers and `text_proj`)
stays within atol 1e-3 end to end, with weight-only as a control that
fails it. The int8 attention tiers, which quantize three calls a UNet
forward, stay within rel-L2 5e-3 of JAX's UNet end to end, closer than the
bf16 tier."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.clip import text as jclip
from flux_generator_tpu.models.musicgen import model as jmg
from flux_generator_tpu.models.sd import config as jcfg
from flux_generator_tpu.models.sd import unet as junet
from flux_generator_tpu.models.t5 import t5 as jt5
from flux_generator_tpu.ops import linear as jlinear
from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
from flux_generator_tpu.runtime.config import set_attn_int8
from flux_generator_tpu_torch.io.params import to_torch
from flux_generator_tpu_torch.models.clip import text as tclip
from flux_generator_tpu_torch.models.musicgen import model as tmg
from flux_generator_tpu_torch.models.sd import config as tcfg
from flux_generator_tpu_torch.models.sd import unet as tunet
from flux_generator_tpu_torch.models.t5 import t5 as tt5
from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
from flux_generator_tpu_torch.ops import linear as tlinear
from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as wm
from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
from flux_generator_tpu_torch.pipelines.sd import StableDiffusion

ROUTES = {"ops": "xla", "rows": "pq", "fused": "pallas"}
ATTN_REL = 5e-3
LOGIT_ATOL = 1e-3


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dense_only(p) -> bool:
    return p["kernel"].ndim <= 3  # every dense layer; 4-D conv kernels stay f32


@pytest.fixture
def jax_w8a8(monkeypatch):
    """Run a function under the JAX package's W8A8 switch with the given
    FGT_W8A8_IMPL."""

    def run(impl, fn):
        monkeypatch.setenv("FGT_W8A8_IMPL", impl)
        jlinear.set_w8a8(True)
        try:
            return fn()
        finally:
            jlinear.set_w8a8(None)

    return run


@pytest.fixture
def jax_attn(monkeypatch):
    """Run a function with the JAX package's Pallas attention on (interpret
    mode) under `set_attn_int8(tier)`."""
    jattn = importlib.import_module("flux_generator_tpu.ops.pallas.flash_attention")
    monkeypatch.setenv("FGT_PALLAS_ATTENTION", "1")
    monkeypatch.setattr(jattn, "flash_attention", functools.partial(jattn.flash_attention, interpret=True))

    def run(tier, fn):
        set_attn_int8(tier or None)
        try:
            return fn()
        finally:
            set_attn_int8(None)

    return run


# ------------------------------------------------------------ SD: UNet


# 16x16 latents: level 0 is a 256-token self-attention of heads of 64 (kernel
# A's route), level 1 64 tokens; widths 128 and 256 give K multiples of 128
UNET = dict(block_out_channels=(128, 256), num_attention_heads=(2, 4), norm_num_groups=32,
            cross_attention_dim=(128, 128))


@functools.lru_cache(maxsize=None)
def _unet():
    cfg_j = jcfg.tiny_unet_config(**UNET)
    pj = jax_quantize_tree(junet.init_unet(jax.random.PRNGKey(4), cfg_j), _dense_only)
    pt = to_torch(jax.tree.map(np.asarray, pj))
    x, ctx, ts = _rand(1, 2, 16, 16, 4), _rand(2, 2, 20, 128), np.array([801.0, 40.0], np.float32)
    return cfg_j, tcfg.tiny_unet_config(**UNET), pj, pt, x, ctx, ts


def _unet_jax_attn(tier, jax_attn):
    """The JAX UNet's output under set_attn_int8(tier), its Pallas flash
    attention on."""
    cfg_j, _, pj, _, x, ctx, ts = _unet()
    return jax_attn(tier, lambda: np.asarray(junet.unet_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(ts),
                                                                 jnp.asarray(ctx))))


def _unet_port(attn_int8=""):
    _, cfg_t, _, pt, x, ctx, ts = _unet()
    return tunet.unet_forward(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                              attn_int8=attn_int8).numpy()


def _took(p, w8a8) -> bool:
    """Whether a dense call takes int8 activations (ops.linear.dense's rule,
    the JAX package's under its switch)."""
    q, scale = p.get("kernel_q"), p.get("kernel_scale")
    return (w8a8 is not None and q is not None and scale.ndim == q.ndim - 1 and "kernel_int4" not in p
            and str(q.dtype).endswith("int8"))


def _port_calls(monkeypatch, modules, fn):
    """fn() with `dense` of the given port modules recorded → (result,
    [(p, x, w8a8)])."""
    calls = []
    for mod in modules:
        real = mod.dense

        def rec(p, x, w8a8=None, _real=real):
            calls.append((p, x, w8a8))
            return _real(p, x, w8a8)

        monkeypatch.setattr(mod, "dense", rec)
    out = fn()
    monkeypatch.undo()
    return out, calls


def _jax_taken(monkeypatch, modules, impl, fn):
    """The (activation shape, kernel shape) of every JAX `dense` call that
    takes the W8A8 branch when fn() is traced under the switch."""
    seen = set()
    for mod in modules:
        real = mod.dense

        def rec(p, x, _real=real):
            if "kernel_q" in p:
                seen.add((tuple(x.shape), tuple(p["kernel_q"].shape), _took(p, "on" if jlinear.w8a8_enabled()
                                                                                else None)))
            return _real(p, x)

        monkeypatch.setattr(mod, "dense", rec)
    monkeypatch.setenv("FGT_W8A8_IMPL", impl)
    jlinear.set_w8a8(True)
    try:
        fn()
    finally:
        jlinear.set_w8a8(None)
        monkeypatch.undo()
    return seen


def _assert_calls_match_jax(calls, route, jax_w8a8, want_taken):
    """The port's int8-activation calls are JAX's, and each distinct one, on
    the port's own inputs, equals JAX's `dense` under the switch."""
    taken = {(tuple(x.shape), tuple(p["kernel_q"].shape), _took(p, w)) for p, x, w in calls if "kernel_q" in p}
    assert taken == want_taken
    assert any(t for *_, t in taken)
    assert all(w == route for *_, w in calls)
    checked = set()
    for p, x, _ in calls:
        key = (tuple(x.shape), tuple(p["kernel_q"].shape)) if "kernel_q" in p else None
        if key is None or key in checked or not _took(p, route):
            continue
        checked.add(key)
        pj = {k: jnp.asarray(np.asarray(v)) for k, v in p.items()}
        want = np.asarray(jax_w8a8(ROUTES[route], lambda: jlinear.dense(pj, jnp.asarray(x.numpy()))))
        got = tlinear.dense(p, x, route).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    return checked


@pytest.mark.parametrize("route", list(ROUTES))
def test_unet_w8a8_route_matches_jax_layer_by_layer(route, jax_w8a8, monkeypatch):
    """Every int8 dense of the UNet through int8 activations, the same
    layers as JAX's under its switch; "fused" and "rows" take kernels G and
    H (their plain versions, no launch counted on CPU tensors)."""
    cfg_j, cfg_t, pj, pt, x, ctx, ts = _unet()
    x = x[:, :8, :8]  # 64 tokens a level-0 attention: the plain attention on both sides
    want = _jax_taken(monkeypatch, [junet], ROUTES[route], lambda: jax.jit(
        lambda p, a, b, c: junet.unet_forward(p, cfg_j, a, b, c)).lower(
        pj, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx)))
    g0, h0 = wm.launches, wm.quantize_launches
    _, calls = _port_calls(monkeypatch, [tunet], lambda: tunet.unet_forward(
        pt, cfg_t, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx), w8a8=route))
    checked = _assert_calls_match_jax(calls, route, jax_w8a8, want)
    assert len(checked) >= 6
    assert (wm.launches, wm.quantize_launches) == (g0, h0)


@pytest.mark.parametrize("tier", ["qk", "full"])
def test_unet_attn_int8_tier_matches_jax(tier, jax_attn):
    """The UNet's 256-token self-attentions take A's int8 tier, as the JAX
    UNet's Pallas flash attention takes it under set_attn_int8; the bf16
    tier is the control."""
    want = _unet_jax_attn(tier, jax_attn)
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, *args, **kwargs):
        calls.append((q.shape[1], kwargs.get("int8", "")))
        return real(q, k, v, *args, **kwargs)

    fa.flash_attention = spy
    try:
        got = _unet_port(attn_int8=tier)
    finally:
        fa.flash_attention = real
    assert calls and {c for c in calls} == {(256, tier)}
    assert _rel(got, want) <= ATTN_REL
    assert _rel(_unet_port(), want) > _rel(got, want)


def test_int8_tier_is_dropped_past_the_one_shot_length():
    """Past 6144 tokens the JAX wrapper drops the tier; so does the port."""
    assert fa.effective_int8(6144, "qk") == "qk"
    assert fa.effective_int8(6400, "qk") == fa.effective_int8(16384, "full") == ""


# ------------------------------------------------------------ SD: the pipeline


class _Tok:
    eos_token = 63

    def tokenize(self, text):
        return [1] + [3 + sum(map(ord, w)) % 57 for w in text.split()] + [63]


def _sd_pipeline():
    """A StableDiffusion over the int8 UNet above and an int8 CLIP."""
    from flux_generator_tpu.models.sd.vae import init_sd_vae

    _, cfg_t, pj_unet, *_ = _unet()
    clip_j = jclip.tiny_clip_config(model_dims=128, num_heads=2)
    clip = jax_quantize_tree(jclip.init_clip_text(jax.random.PRNGKey(5), clip_j), _dense_only)
    ae = jcfg.tiny_sd_ae_config()
    pj = {"unet": pj_unet, "vae": init_sd_vae(jax.random.PRNGKey(6), ae), "clip": clip}
    return StableDiffusion("sd", to_torch(jax.tree.map(np.asarray, pj)), cfg_t,
                           tcfg.AutoencoderConfig(**dataclasses.asdict(ae)),
                           [tclip.CLIPTextConfig(**dataclasses.asdict(clip_j))], tokenizers=[_Tok()],
                           dtype=torch.float32)


@pytest.mark.parametrize("route,tier", [("fused", ""), ("rows", "full"), ("ops", "qk")])
def test_sd_pipeline_passes_its_route_and_tier(route, tier, monkeypatch):
    """StableDiffusion(w8a8=, attn_int8=) passes its route to every CLIP
    and UNet dense and its tier to the UNet's 256-token self-attention."""
    tpipe = _sd_pipeline()
    tpipe.w8a8, tpipe.attn_int8 = route, tier
    cond, clip_calls = _port_calls(monkeypatch, [tclip], lambda: tpipe.get_text_conditioning(
        "a red fox", 1, 4.0, "blurry"))
    tiers = []
    real = fa.flash_attention

    def spy(q, k, v, *args, **kwargs):
        tiers.append(kwargs.get("int8", ""))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", spy)
    x = torch.from_numpy(_rand(7, 1, 16, 16, 4))
    eps, unet_calls = _port_calls(monkeypatch, [tunet], lambda: tpipe._eps(x, torch.tensor(700.0), cond, 4.0,
                                                                            True, None))
    assert eps.shape == (1, 16, 16, 4) and tiers and set(tiers) == {tier}
    calls = clip_calls + unet_calls
    assert clip_calls and unet_calls and all(w == route for *_, w in calls)
    # the int8 ones take int8 activations (each such layer is held to JAX's in the UNet test above)
    assert any(_took(p, w) for p, _, w in clip_calls) and any(_took(p, w) for p, _, w in unet_calls)


def test_sd_from_random_init_takes_the_routes():
    pipe = StableDiffusion.random_init(tiny=True, device="cpu", w8a8="rows", attn_int8="full")
    assert (pipe.w8a8, pipe.attn_int8) == ("rows", "full")


# ------------------------------------------------------------ MusicGen


# hidden 128 (K a multiple of 128), ffn 256 (not 4 × hidden: the plain layer
# loop, where the JAX package's W8A8 switch applies); 8 samples → 16 CFG rows
MG = dict(hidden_size=128, num_attention_heads=2, ffn_dim=256, text_d_model=128, codebook_size=32, bos_token_id=32)


@functools.lru_cache(maxsize=None)
def _musicgen():
    cfg_j = jmg.tiny_musicgen_config(**MG)
    pj = jmg.init_musicgen(jax.random.PRNGKey(7), cfg_j)
    pj = dict(pj, layers=jax_quantize_tree(pj["layers"], _dense_only),
              text_proj=jax_quantize_tree({"p": pj["text_proj"]}, _dense_only)["p"])
    return cfg_j, tmg.MusicGenConfig(**dataclasses.asdict(cfg_j)), pj, to_torch(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("route", list(ROUTES))
def test_musicgen_decode_step_w8a8_matches_jax_layer_by_layer(route, jax_w8a8, monkeypatch):
    """The plain layer loop's projections (self-attention qkv and out,
    cross-attention out, the two FFN layers) through int8 activations, the
    same ones as JAX's under its switch; the cross-attention q reads its
    kernel dequantized on both sides."""
    cfg_j, cfg_t, pj, pt = _musicgen()
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((16, 6, cfg_j.hidden_size)).astype(np.float32)
    tok = rng.integers(0, cfg_j.codebook_size + 1, (16, 1, cfg_j.num_codebooks))

    def jax_side():
        ckv = jmg.precompute_cross_kv(pj, cfg_j, jnp.asarray(cond))
        kc, vc = jmg.init_kv_cache(cfg_j, 16, 4, jnp.float32)
        return jax.jit(lambda t: jmg.decode_step(pj, cfg_j, t, ckv, kc, vc, jnp.int32(0))).lower(jnp.asarray(tok))

    want = _jax_taken(monkeypatch, [jmg], ROUTES[route], jax_side)
    ckv = tmg.precompute_cross_kv(pt, cfg_t, torch.from_numpy(cond))
    kc, vc = tmg.init_kv_cache(cfg_t, 16, 4, torch.float32)
    _, calls = _port_calls(monkeypatch, [tmg], lambda: tmg.decode_step(
        pt, cfg_t, torch.from_numpy(tok), ckv, kc, vc, 0, w8a8=route))
    checked = _assert_calls_match_jax(calls, route, jax_w8a8, want)
    assert {k for _, k in checked} == {(128, 384), (128, 128), (128, 256), (256, 128)}


@functools.lru_cache(maxsize=None)
def _t5():
    cfg_j = jt5.tiny_t5_config(d_model=128, d_kv=64, num_heads=2, d_ff=256, vocab_size=64)
    pj = jax_quantize_tree(jt5.init_t5_encoder(jax.random.PRNGKey(9), cfg_j), _dense_only)
    return cfg_j, tt5.T5Config(**dataclasses.asdict(cfg_j)), pj, to_torch(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("route", list(ROUTES))
def test_musicgen_conditioning_w8a8_matches_jax(route, jax_w8a8):
    """T5's int8 denses and `text_proj` through int8 activations on a
    20-token prompt, and MusicGenPipeline(w8a8=) passing its route to both."""
    cfg_j, cfg_t, pj_t5, pt_t5 = _t5()
    mcfg_j, mcfg_t, pj, pt = _musicgen()
    tokens = np.random.default_rng(10).integers(1, 64, (1, 20))

    def jax_side():
        feats = jt5.t5_encode(pj_t5, cfg_j, jnp.asarray(tokens))
        return np.asarray(jmg.condition_text(pj, feats))

    want = jax_w8a8(ROUTES[route], jax_side)

    class _Tok:
        def encode(self, text, pad=True):
            return tokens[0].tolist()

    codec = MusicGenPipeline.random_init(device="cpu").audio_decoder
    pipe = MusicGenPipeline(mcfg_t, pt, cfg_t, pt_t5, codec, tokenizer=_Tok(), w8a8=route)
    got = pipe.conditioning("twenty tokens of prompt").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    pipe.w8a8 = None
    assert np.abs(pipe.conditioning("x").numpy() - want).max() > LOGIT_ATOL


def test_fused_decode_step_is_unchanged_by_the_route():
    """At ffn = 4 × hidden the loop takes the fused step (kernel D's plain
    version here), which reads its weights itself, as the JAX package's
    Pallas step does: the W8A8 route leaves its codes as they are."""
    cfg_j = jmg.tiny_musicgen_config(hidden_size=128, num_attention_heads=2, ffn_dim=512, codebook_size=32,
                                     bos_token_id=32)
    pj = jmg.init_musicgen(jax.random.PRNGKey(11), cfg_j)
    pj = dict(pj, layers=jax_quantize_tree(pj["layers"], _dense_only))
    cfg_t, pt = tmg.MusicGenConfig(**dataclasses.asdict(cfg_j)), to_torch(jax.tree.map(np.asarray, pj))
    cond = torch.from_numpy(_rand(12, 8, 5, 128))
    codes = {route: tmg.generate(pt, cfg_t, cond, max_steps=8, top_k=1, generator=torch.Generator().manual_seed(0),
                                 w8a8=route) for route in (None, "fused", "rows")}
    assert torch.equal(codes[None], codes["fused"]) and torch.equal(codes[None], codes["rows"])
