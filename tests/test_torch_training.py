"""DreamBooth LoRA training, ported modules against the JAX package (CPU,
f32, tiny config): the flow-matching loss at injected timesteps and noise,
LoRA gradients over an f32 and an int8 base, the Adam + warmup-cosine
trajectory with accumulation and a block mask, the VAE encode, LoRA in
`dense` on every weight tier, and the LoRA tree helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.flux import autoencoder as jae
from flux_generator_tpu.models.flux import sampler as jsampler
from flux_generator_tpu.models.flux.model import init_flux, tiny_flux_config
from flux_generator_tpu.ops import linear as jlinear
from flux_generator_tpu.ops.quant import quantize_dense as jax_quantize_dense
from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
from flux_generator_tpu.pipelines import flux as jflux
from flux_generator_tpu.training import dreambooth as jdb
from flux_generator_tpu.training import lora as jlora
from flux_generator_tpu_torch.io.params import to_torch, tree_leaves
from flux_generator_tpu_torch.models.flux import autoencoder as tae
from flux_generator_tpu_torch.models.flux import sampler as tsampler
from flux_generator_tpu_torch.ops import linear as tlinear
from flux_generator_tpu_torch.ops.quant import quantize_dense
from flux_generator_tpu_torch.pipelines import flux as tflux
from flux_generator_tpu_torch.training import dreambooth as tdb
from flux_generator_tpu_torch.training import lora as tlora
from tests.test_torch_bridge import all_layers, jax_to_torch


def _paths(tree, prefix=""):
    """[(dotted path, leaf)] of a dict/list tree, jax or torch leaves."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _paths(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in _paths(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _lora_flow(seed=0, quantize=False):
    """A tiny JAX flux-dev flow with adapters whose lora_b is nonzero (it
    initialises to zeros, which makes the gradient of lora_a vanish)."""
    flow_cfg = tiny_flux_config(guidance_embed=True)
    ae_cfg = jae.tiny_ae_config(z_channels=flow_cfg.in_channels // 4)
    # neither the text encoders nor the VAE are needed: the tests give the
    # features and the latents (the encode tests build their own VAE)
    # jitted: one compile for the whole init instead of one per op
    params = {"flow": jax.jit(init_flux, static_argnums=(1, 2))(jax.random.PRNGKey(seed), flow_cfg,
                                                                jnp.float32)}
    pipe = jflux.FluxPipeline("flux-dev", params, flow_cfg, ae_cfg, None, None, dtype=jnp.float32)
    flow = jlora.apply_lora_to_flux(pipe.params["flow"], rank=2, key=jax.random.PRNGKey(seed + 1))
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape).astype(np.float32))
                        if k == "lora_b" else fill(v)) for k, v in node.items()}
        return node

    flow = fill(flow)
    if quantize:
        flow = jax_quantize_tree(flow, all_layers, bits=8)
    pipe.params["flow"] = flow
    return pipe


def _port_pipeline(pipe_j):
    return tflux.FluxPipeline("flux-dev", jax_to_torch(pipe_j.params), pipe_j.flow_cfg,
                              pipe_j.ae_cfg, pipe_j.clip_cfg, pipe_j.t5_cfg, dtype=torch.float32)


def _batch(pipe_j, seed, b=2, h=8, w=8):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b, h, w, pipe_j.flow_cfg.in_channels // 4)).astype(np.float32)
    t5 = rng.standard_normal((b, 5, pipe_j.flow_cfg.context_in_dim)).astype(np.float32)
    clip = rng.standard_normal((b, pipe_j.flow_cfg.vec_in_dim)).astype(np.float32)
    guidance = np.full((b,), 3.0, np.float32)
    return x0, t5, clip, guidance


def _jax_draws(key, x0, schnell):
    """The t and eps that the JAX training_loss draws from `key`."""
    b, h, w, c = x0.shape
    kt, ke = jax.random.split(key)
    t = jsampler.random_timesteps(kt, b, h * w // 4, schnell)
    eps = jax.random.normal(ke, (b, h * w // 4, 4 * c), jnp.float32)
    return np.array(t), np.array(eps)


@pytest.fixture(scope="module")
def pipelines():
    pipe_j = _lora_flow()
    return pipe_j, _port_pipeline(pipe_j)


@pytest.mark.parametrize("schnell", [False, True])
def test_training_loss_matches_jax(pipelines, schnell):
    """rel 1e-5: f32 on both sides, the noise drawn from the same key splits."""
    pipe_j, pipe_t = pipelines
    pipe_j.schnell = pipe_t.schnell = schnell
    try:
        x0, t5, clip, g = _batch(pipe_j, 1)
        key = jax.random.PRNGKey(11)
        want = float(pipe_j.training_loss(pipe_j.params["flow"], key, jnp.asarray(x0),
                                          jnp.asarray(t5), jnp.asarray(clip), jnp.asarray(g)))
        t, eps = _jax_draws(key, x0, schnell)
        got = pipe_t._training_loss_at(pipe_t.params["flow"], torch.from_numpy(x0),
                                       torch.from_numpy(t), torch.from_numpy(eps),
                                       torch.from_numpy(t5), torch.from_numpy(clip),
                                       torch.from_numpy(g)).item()
    finally:
        pipe_j.schnell = pipe_t.schnell = False
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("quantize", [False, True])
def test_lora_grads_match_jax(quantize):
    """Gradients over extract_lora only, base f32 or int8: rel-L2 ≤ 1e-4
    per leaf."""
    pipe_j = _lora_flow(seed=2, quantize=quantize)
    pipe_t = _port_pipeline(pipe_j)
    x0, t5, clip, g = _batch(pipe_j, 3)
    key = jax.random.PRNGKey(5)
    flow_j = pipe_j.params["flow"]

    def loss(lp):
        return pipe_j.training_loss(jlora.merge_lora(flow_j, lp), key, jnp.asarray(x0),
                                    jnp.asarray(t5), jnp.asarray(clip), jnp.asarray(g))

    want = dict(_paths(jax.jit(jax.grad(loss))(jlora.extract_lora(flow_j))))

    flow_t = pipe_t.params["flow"]
    lora = tlora.extract_lora(flow_t)
    leaves = tree_leaves(lora)
    for p in leaves:
        p.requires_grad_(True)
    t, eps = _jax_draws(key, x0, False)
    loss_t = pipe_t._training_loss_at(tlora.merge_lora(flow_t, lora), torch.from_numpy(x0),
                                      torch.from_numpy(t), torch.from_numpy(eps),
                                      torch.from_numpy(t5), torch.from_numpy(clip),
                                      torch.from_numpy(g))
    grads = torch.autograd.grad(loss_t, leaves)
    base = [p for p in tree_leaves(flow_t) if all(p is not q for q in leaves)]
    assert not any(p.requires_grad for p in base)
    got = dict(zip((path for path, _ in _paths(lora)), grads))
    assert set(got) == set(want) and len(got) > 20
    for path, gr in got.items():
        w = np.asarray(want[path])
        rel = np.linalg.norm(gr.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-4, (path, rel)


class _JaxQuadratic:
    """Stand-in pipeline: loss = Σ_leaves mean((leaf − x0·T)²) over the LoRA
    leaves, so each micro-batch gives other gradients."""

    def __init__(self, targets):
        self.targets = {k: jnp.asarray(v) for k, v in targets.items()}

    def training_loss(self, flow, key, x0, t5f, clipf, guidance):
        lora = dict(_paths(jlora.extract_lora(flow)))
        return sum(jnp.mean((lora[k] - x0 * t) ** 2) for k, t in self.targets.items())


class _TorchQuadratic:
    def __init__(self, targets):
        self.targets = {k: torch.from_numpy(v) for k, v in targets.items()}

    def training_loss(self, flow, generator, x0, t5f, clipf, guidance):
        lora = dict(_paths(tlora.extract_lora(flow)))
        return sum(torch.mean((lora[k] - x0 * t) ** 2) for k, t in self.targets.items())


def test_adam_trajectory_matches_optax():
    """Six updates with grad_accumulate=2, a last-2-blocks mask (the tiny
    config has 2 double + 2 single blocks, so only the single blocks train),
    warmup 2 of 6 at lr 1e-2, against the JAX make_train_step (optax):
    max|Δ| ≤ 1e-6 in f32."""
    pipe_j = _lora_flow(seed=4)
    flow_j = pipe_j.params["flow"]
    flow_t = jax_to_torch(flow_j)
    rng = np.random.default_rng(7)
    targets = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in _paths(jlora.extract_lora(flow_j))}
    xs = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    cfg = pipe_j.flow_cfg

    opt_j = jdb.build_optimizer(1e-2, 2, 6)
    lora_j = jlora.extract_lora(flow_j)
    state_j = opt_j.init(lora_j)
    mask_j = jlora.extract_lora(jlora.lora_block_mask(flow_j, 2, cfg.depth, cfg.depth_single_blocks))
    step_j = jdb.make_train_step(_JaxQuadratic(targets), opt_j, flow_j, 2, block_mask=mask_j)
    accum_j = jax.tree.map(jnp.zeros_like, lora_j)

    opt_t = tdb.build_optimizer(1e-2, 2, 6)
    lora_t = tlora.extract_lora(flow_t)
    for p in tree_leaves(lora_t):
        p.requires_grad_(True)
    state_t = opt_t.init(lora_t)
    mask_t = tlora.extract_lora(tlora.lora_block_mask(flow_t, 2, cfg.depth, cfg.depth_single_blocks))
    step_t = tdb.make_train_step(_TorchQuadratic(targets), opt_t, flow_t, 2, block_mask=mask_t)
    accum_t = None
    key = jax.random.PRNGKey(0)
    for i in range(12):
        flags = dict(is_first=i % 2 == 0, should_step=i % 2 == 1)
        _, lora_j, state_j, accum_j = step_j(lora_j, state_j, accum_j, key, jnp.asarray(xs[i]),
                                             None, None, None, **flags)
        _, lora_t, state_t, accum_t = step_t(lora_t, state_t, accum_t, None,
                                             torch.tensor(xs[i]), None, None, None, **flags)
    assert state_t["count"] == 6
    want = dict(_paths(lora_j))
    before = dict(_paths(jlora.extract_lora(flow_j)))
    moved = 0
    for path, p in _paths(lora_t):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[path]), atol=1e-6, err_msg=path)
        changed = not np.array_equal(np.asarray(want[path]), np.asarray(before[path]))
        assert changed == path.startswith("single_blocks"), path
        moved += changed
    assert moved > 0


def test_schedule_matches_optax():
    """The schedule jdb.build_optimizer hands optax.adam."""
    import optax

    ours = tdb.warmup_cosine(3e-4, 3, 10)

    ref = optax.join_schedules([optax.linear_schedule(0.0, 3e-4, 3),
                                optax.cosine_decay_schedule(3e-4, 7)], [3])
    for step in range(14):
        assert abs(ours(step) - float(ref(step))) <= 1e-10


_AE = dict(ch=8, ch_mult=(1, 2, 2), num_res_blocks=1, z_channels=4)


@pytest.fixture(scope="module")
def vae():
    """A small VAE (two stride-2 downsamples): JAX config and params, the
    port's config and params."""
    params_j = jax.jit(jae.init_autoencoder, static_argnums=(1,))(jax.random.PRNGKey(3),
                                                                  jae.AutoEncoderConfig(**_AE))
    return jae.AutoEncoderConfig(**_AE), params_j, tae.AutoEncoderConfig(**_AE), jax_to_torch(params_j)


def test_encode_matches_jax(vae):
    """The VAE encode (the (0, 1)-padded stride-2 downsample included) at
    atol 1e-5."""
    cfg_j, params_j, cfg_t, params_t = vae
    x = np.random.default_rng(8).uniform(-1, 1, (2, 24, 16, 3)).astype(np.float32)
    want = np.asarray(jae.encode(params_j, cfg_j, jnp.asarray(x)))
    got = tae.encode(params_t, cfg_t, torch.from_numpy(x))
    assert got.shape == (2, 6, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pipeline_encode_image_matches_jax(vae):
    """The trainer's entry `_encode_image` against the JAX pipeline's, also
    past 1024 px, where both encode in overlapping 768² tiles."""
    cfg_j, params_j, cfg_t, params_t = vae
    flow_cfg = tiny_flux_config(guidance_embed=True)
    pipe_j = jflux.FluxPipeline("flux-dev", {"ae": params_j}, flow_cfg, cfg_j, None, None,
                                dtype=jnp.float32)
    pipe_t = tflux.FluxPipeline("flux-dev", {"ae": params_t}, flow_cfg, cfg_t, None, None,
                                dtype=torch.float32)
    x = np.random.default_rng(9).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    want = np.asarray(pipe_j._encode_image(pipe_j.params, jnp.asarray(x)))
    np.testing.assert_allclose(pipe_t._encode_image(torch.from_numpy(x)).numpy(), want, atol=1e-5)
    big = np.random.default_rng(10).uniform(-1, 1, (1, 1040, 16, 3)).astype(np.float32)
    want = np.asarray(pipe_j._encode_image(pipe_j.params, jnp.asarray(big)))
    got = pipe_t._encode_image(torch.from_numpy(big))
    assert got.shape == want.shape == (1, 260, 4, cfg_t.z_channels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_sampler_noise_and_timesteps():
    rng = np.random.default_rng(10)
    x, eps = rng.standard_normal((2, 2, 3, 4, 5)).astype(np.float32)
    t = np.array([0.25, 0.8], np.float32)
    want = np.asarray(jsampler.add_noise(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps)))
    got = tsampler.add_noise(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    ts = tsampler.random_timesteps(g, 64, 1024, schnell=True)
    assert set(ts.tolist()) <= {0.25, 0.5, 0.75, 1.0} and len(set(ts.tolist())) > 1
    td = tsampler.random_timesteps(g, 64, 1024, schnell=False)
    assert td.dtype == torch.float32 and ((td > 0) & (td < 1)).all()
    # the dev shift of a uniform draw u: e^μ / (e^μ + 1/u − 1), μ at 1024 tokens
    g2 = torch.Generator().manual_seed(0)
    tsampler.random_timesteps(g2, 64, 1024, schnell=True)
    u = torch.rand((64,), generator=g2)
    mu = (1024 - 256.0) * 0.65 / 3840 + 0.5
    np.testing.assert_allclose(td.numpy(), (np.exp(mu) / (np.exp(mu) + 1 / u.numpy() - 1)), rtol=1e-6)


def _tier(p, tier):
    if tier == "f32":
        return p
    if tier == "int8":
        return jax_quantize_dense(p)
    if tier == "int8_g32":
        return jax_quantize_dense(p, group_size=32)
    if tier == "int4_packed":
        return jax_quantize_dense(p, bits=4, pack=True)
    return jax_quantize_dense(p, bits=4, group_size=32, pack=True)


@pytest.mark.parametrize("tier", ["f32", "int8", "int8_g32", "int4_packed", "int4_packed_g32"])
def test_lora_dense_on_each_tier(tier):
    """y = base(x) + (x @ A) @ B + bias on every weight tier, against the JAX
    dense; atol 1e-5."""
    rng = np.random.default_rng(12)
    p = jlinear.init_dense(jax.random.PRNGKey(1), 128, 48)
    p = _tier(p, tier)
    p["lora_a"] = jnp.asarray(rng.standard_normal((128, 4)).astype(np.float32) * 0.1)
    p["lora_b"] = jnp.asarray(rng.standard_normal((4, 48)).astype(np.float32) * 0.1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    want = np.asarray(jlinear.dense(p, jnp.asarray(x)))
    got = tlinear.dense(jax_to_torch(p), torch.from_numpy(x))
    no_lora = tlinear.dense(jax_to_torch({k: v for k, v in p.items() if "lora" not in k}),
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert not np.allclose(no_lora.numpy(), want, atol=1e-3)


def test_quantize_dense_keeps_the_adapters():
    p = {"kernel": torch.randn(64, 16), "bias": torch.randn(16), "lora_a": torch.randn(64, 2),
         "lora_b": torch.randn(2, 16)}
    for kw in ({}, {"bits": 4, "group_size": 32, "pack": True}):
        q = quantize_dense(p, **kw)
        assert q["lora_a"] is p["lora_a"] and q["lora_b"] is p["lora_b"] and "kernel" not in q


def test_apply_lora_shapes_and_bounds(pipelines):
    pipe_j, _ = pipelines
    base_j = {k: v for k, v in pipe_j.params["flow"].items()}
    base_t = jax_to_torch(jlora.fuse_lora(base_j))  # a flow without adapters
    flow = tlora.apply_lora_to_flux(base_t, rank=3, generator=torch.Generator().manual_seed(1))
    want = {path for path, _ in _paths(jlora.extract_lora(
        jlora.apply_lora_to_flux(jlora.fuse_lora(base_j), rank=3)))}
    got = dict(_paths(tlora.extract_lora(flow)))
    assert set(got) == want
    leaves = dict(_paths(flow))
    for path, t in got.items():
        kern = leaves[path.rsplit(".", 1)[0] + ".kernel"]
        layers, d_in, d_out = kern.shape
        if path.endswith("lora_a"):
            assert t.shape == (layers, d_in, 3) and t.abs().max() <= d_in ** -0.5
            assert t.abs().max() > 0.5 * d_in ** -0.5
        else:
            assert t.shape == (layers, 3, d_out) and not t.any()
    assert "lora_a" not in flow["final_layer"]["linear"]


def test_fuse_lora_and_block_mask_match_jax(pipelines):
    pipe_j, _ = pipelines
    flow_j = pipe_j.params["flow"]
    want = jax.tree.map(np.asarray, jlora.fuse_lora(flow_j))
    got = tlora.fuse_lora(jax_to_torch(flow_j))
    assert not tlora.extract_lora(got)
    for (pw, w), (pg, g) in zip(sorted(_paths(want)), sorted(_paths(got))):
        assert pw == pg
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, err_msg=pw)
    cfg = pipe_j.flow_cfg
    for n in (-1, 1, 3):
        mj = dict(_paths(jlora.extract_lora(jlora.lora_block_mask(flow_j, n, cfg.depth,
                                                                  cfg.depth_single_blocks))))
        mt = dict(_paths(tlora.extract_lora(tlora.lora_block_mask(jax_to_torch(flow_j), n, cfg.depth,
                                                                  cfg.depth_single_blocks))))
        assert set(mj) == set(mt)
        for k in mj:
            np.testing.assert_array_equal(mt[k].numpy(), np.asarray(mj[k]))
    only = tlora.lora_only_filter(jax_to_torch(flow_j))
    assert only["double_blocks"]["img_mod"]["lora_a"] and not only["double_blocks"]["img_mod"]["kernel"]


def test_params_bridge_carries_lora_and_adam_state(pipelines):
    """A LoRA tree and an optax Adam state survive JAX → numpy → torch →
    numpy exactly (named tuples keep their type)."""
    from flux_generator_tpu_torch.io.params import to_numpy

    pipe_j, _ = pipelines
    lora = jlora.extract_lora(pipe_j.params["flow"])
    state = jdb.build_optimizer(1e-3, 2, 10).init(lora)
    for tree in (lora, state):
        want = jax.tree.map(np.asarray, tree)
        got = to_numpy(to_torch(want))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
