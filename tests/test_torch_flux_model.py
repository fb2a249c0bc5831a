"""flux_forward of the port against the JAX package's at tiny config (CPU,
f32). atol 1e-4: one forward is ~20 f32 matmuls, norms and softmaxes deep,
and the two sides sum in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.models.flux import model as jmodel
from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
from flux_generator_tpu_torch.models.flux import model as tmodel
from tests.test_torch_bridge import all_layers, jax_to_torch


def _inputs(cfg, b=2, l_img=16, l_txt=5, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, l_img, cfg.in_channels)).astype(np.float32)
    side = int(l_img ** 0.5)
    r, c = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    img_ids = np.broadcast_to(np.stack([np.zeros_like(r), r, c], -1).reshape(1, -1, 3),
                              (b, l_img, 3)).astype(np.int32)
    txt = rng.standard_normal((b, l_txt, cfg.context_in_dim)).astype(np.float32)
    txt_ids = np.zeros((b, l_txt, 3), np.int32)
    t = np.array([1.0, 0.5][:b], np.float32)
    y = rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32)
    guidance = np.full((b,), 4.0, np.float32)
    return dict(img=img, img_ids=img_ids, txt=txt, txt_ids=txt_ids, timesteps=t, y=y,
                guidance=guidance)


@pytest.mark.parametrize("variant", ["schnell", "guidance_embed", "int8_flow"])
def test_flux_forward_matches_jax(variant):
    cfg_kw = dict(guidance_embed=True) if variant == "guidance_embed" else {}
    jcfg = jmodel.tiny_flux_config(**cfg_kw)
    tcfg = tmodel.tiny_flux_config(**cfg_kw)
    params = jmodel.init_flux(jax.random.PRNGKey(1), jcfg)
    if variant == "int8_flow":
        params = jax_quantize_tree(params, all_layers, bits=8)
    inp = _inputs(jcfg)
    if not jcfg.guidance_embed:
        inp["guidance"] = None
    want = jmodel.flux_forward(params, jcfg, **{k: None if v is None else jnp.asarray(v)
                                                for k, v in inp.items()})
    got = tmodel.flux_forward(jax_to_torch(params), tcfg,
                              **{k: None if v is None else torch.from_numpy(v)
                                 for k, v in inp.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_guidance_model_needs_guidance():
    cfg = tmodel.tiny_flux_config(guidance_embed=True)
    params = tmodel.init_flux(torch.Generator().manual_seed(0), cfg)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items() if k != "guidance"}
    with pytest.raises(ValueError):
        tmodel.flux_forward(params, cfg, **inp)


def test_port_init_matches_jax_tree_layout():
    cfg = tmodel.tiny_flux_config(guidance_embed=True)
    got = tmodel.init_flux(torch.Generator().manual_seed(0), cfg)
    want = jmodel.init_flux(jax.random.PRNGKey(0), jmodel.tiny_flux_config(guidance_embed=True))
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), got)
    want_shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert got_shapes == want_shapes
