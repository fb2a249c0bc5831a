"""The "dots" recomputation policy of flux_forward (the JAX package's
set_remat_policy("dots"): jax.checkpoint_policies.
dots_with_no_batch_dims_saveable) against "block" and against JAX's
gradients under that policy (CPU, f32, tiny config, atol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flux_generator_tpu.models.flux import model as jmodel
from flux_generator_tpu.runtime.config import set_remat_policy
from flux_generator_tpu_torch.io.params import to_numpy, tree_leaves
from flux_generator_tpu_torch.models.flux import model as tmodel
from flux_generator_tpu_torch.training.dreambooth import build_parser
from tests.test_torch_parallel import _one_thread  # noqa: F401 (autouse)


def _inputs(cfg, b=2, l_img=8, l_txt=4):
    rng = np.random.default_rng(0)
    return dict(img=rng.standard_normal((b, l_img, cfg.in_channels)).astype(np.float32),
                img_ids=np.zeros((b, l_img, 3), np.int32),
                txt=rng.standard_normal((b, l_txt, cfg.context_in_dim)).astype(np.float32),
                txt_ids=np.zeros((b, l_txt, 3), np.int32),
                timesteps=np.array([0.9, 0.3], np.float32)[:b],
                y=rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32))


class _CountMM(TorchDispatchMode):
    """Counts the 2-D products the dispatcher sees."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads(params, cfg, inp, remat):
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    out = tmodel.flux_forward(params, cfg, **inp, remat=remat)
    loss = (out ** 2).sum()
    with _CountMM() as counter:
        grads = torch.autograd.grad(loss, tree_leaves(params))
    return grads, counter.n


@pytest.fixture(scope="module")
def port():
    cfg = tmodel.tiny_flux_config()
    params = tmodel.init_flux(torch.Generator().manual_seed(0), cfg)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    return cfg, params, inp, {r: _grads(params, cfg, inp, r) for r in (False, "block", "dots")}


def test_dots_gradients_equal_block_gradients(port):
    _, _, _, res = port
    for remat in ("block", "dots"):
        for a, b in zip(res[False][0], res[remat][0]):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_dots_saves_the_products_that_block_recomputes(port):
    """The control: "block" reruns every 2-D product of the forward in the
    backward, "dots" none of them (the backward's own products remain)."""
    _, _, _, res = port
    plain, block, dots = res[False][1], res["block"][1], res["dots"][1]
    assert block > plain and dots == plain


def test_dots_gradients_match_jax(port):
    cfg, params, inp, res = port
    jcfg = jmodel.tiny_flux_config()
    args = tuple(jnp.asarray(inp[k].numpy()) for k in ("img", "img_ids", "txt", "txt_ids", "timesteps", "y"))
    set_remat_policy("dots")
    try:
        grad = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.flux_forward(p, jcfg, *args, remat=True) ** 2)))(
            jax.tree.map(jnp.asarray, to_numpy(params)))
    finally:
        set_remat_policy(None)
    want = {"/".join(k.key for k in path): np.asarray(g) for path, g in jax.tree_util.tree_flatten_with_path(grad)[0]}

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in paths(v, f"{prefix}/{k}" if prefix else k)]
        return [prefix]

    for path, g in zip(paths(params), res["dots"][0]):
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-4)


def test_unknown_policy_raises(port):
    cfg, params, inp, _ = port
    with pytest.raises(ValueError, match="block|dots"):
        tmodel.flux_forward(params, cfg, **inp, remat="layers")
    assert tmodel.remat_policy(True) == "block" and tmodel.remat_policy(False) is None


def test_trainer_takes_the_policy_as_an_argument():
    assert build_parser().parse_args(["data"]).remat_policy == "block"
    assert build_parser().parse_args(["data", "--remat-policy", "dots"]).remat_policy == "dots"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["data", "--remat-policy", "layers"])


def test_training_loss_under_dots_equals_block():
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    pipe = FluxPipeline.random_init("flux-dev", tiny=True, dtype=torch.float32, device="cpu")
    flow = pipe.params["flow"]
    for leaf in tree_leaves(flow):
        leaf.requires_grad_(True)
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((2, 4, 4, pipe.ae_cfg.z_channels), generator=g)
    t5f = torch.randn((2, 4, pipe.flow_cfg.context_in_dim), generator=g)
    clipf = torch.randn((2, pipe.flow_cfg.vec_in_dim), generator=g)
    guidance = torch.full((2,), 3.0)
    out = {}
    for remat in ("block", "dots"):
        loss = pipe.training_loss(flow, torch.Generator().manual_seed(7), x0, t5f, clipf, guidance, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, tree_leaves(flow)))
    assert torch.equal(out["block"][0], out["dots"][0])
    for a, b in zip(out["block"][1], out["dots"][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
