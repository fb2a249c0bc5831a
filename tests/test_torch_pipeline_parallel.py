"""Pipeline parallelism (parallel/pipeline.py) against the JAX package's
(tests/test_pipeline_parallel.py) on the CPU: 4 gloo ranks in f32, spawned
once (2-stage cases run on both pairs of ranks, a ("data", "pipe") mesh),
against JAX's pipeline_scan on the 8 virtual devices, its gradients, and
flux_forward under PP, PP × TP and PP with recomputation; pad_stack's zero
blocks as identities for float, int8 and int4 stacks. Bounds: 1e-5 on
outputs and 1e-4 on gradients (the JAX tests'), 2e-4 and 5e-4 on the Flux
forward and its gradients."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.io.params import take_layer, to_numpy, to_torch, tree_leaves
from flux_generator_tpu_torch.models.flux import model as tmodel
from flux_generator_tpu_torch.ops.quant import is_k_major, quantize_tree
from flux_generator_tpu_torch.parallel.mesh import Mesh
from flux_generator_tpu_torch.parallel.pipeline import default_microbatches, pad_stack, pipeline_scan
from tests.test_torch_parallel import spawn_ranks

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4
MLP_CASES = ((2, 2), (4, 2), (4, 4))  # (stages, microbatches)
from tests.test_torch_parallel import _one_thread  # noqa: F401 (autouse)


def _mlp_body(x, p, scale):
    return x + scale * torch.tanh(x @ p["w1"]) @ p["w2"]


def _flux_inputs(cfg, b, l_img, l_txt, seed):
    rng = np.random.default_rng(seed)
    return dict(img=rng.standard_normal((b, l_img, cfg.in_channels)).astype(np.float32),
                img_ids=np.zeros((b, l_img, 3), np.int32),
                txt=rng.standard_normal((b, l_txt, cfg.context_in_dim)).astype(np.float32),
                txt_ids=np.zeros((b, l_txt, 3), np.int32),
                timesteps=np.full((b,), 0.5, np.float32),
                y=rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32))


def _t(tree):
    return to_torch(tree) if isinstance(tree, dict) else torch.from_numpy(np.ascontiguousarray(tree))


def _pp_checks(rank, world, payload):
    from flux_generator_tpu_torch.parallel.pipeline import pipeline_tp_sharding, shard_pipeline_params
    from flux_generator_tpu_torch.parallel.sharding import shard_params
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    res = {}
    meshes = {2: Mesh({"data": 2, "pipe": 2}), 4: Mesh({"pipe": 4})}
    mlp = to_torch(payload["mlp"])
    x, scale, scale_ex = (_t(payload[n]) for n in ("x", "scale", "scale_ex"))
    for stages, m in MLP_CASES:
        res[f"mlp_{stages}_{m}"] = pipeline_scan(_mlp_body, x, mlp, meshes[stages], "pipe", m, (scale,)).numpy()
    res["extras"] = pipeline_scan(_mlp_body, x, mlp, meshes[4], "pipe", 4, (scale_ex,)).numpy()
    x3 = x[:3]
    res["odd"] = pipeline_scan(_mlp_body, x3, mlp, meshes[2], "pipe", None, (scale[:3],)).numpy()

    # gradients at 2 stages: this stage's layers (a StageStack of its chunk)
    stage = shard_pipeline_params(mlp, meshes[2], "pipe")
    for leaf in tree_leaves(stage):
        leaf.requires_grad_(True)
    out = pipeline_scan(_mlp_body, x, stage, meshes[2], "pipe", 2, (scale,))
    grads = torch.autograd.grad((out ** 2).sum(), tree_leaves(stage))
    res["grad_stage"] = meshes[2].index("pipe")
    res["grads"] = [g.numpy() for g in grads]

    for what, call in (("depth", lambda: pipeline_scan(_mlp_body, x, take3(mlp), meshes[2], "pipe", None, (scale,))),
                       ("microbatches", lambda: pipeline_scan(_mlp_body, x, mlp, meshes[2], "pipe", 3, (scale,)))):
        try:
            call()
            res[f"error_{what}"] = None
        except ValueError as e:
            res[f"error_{what}"] = str(e)

    # Flux: both stacks pipelined over 2 stages, then PP × TP on 2 × 2
    cfg = tmodel.tiny_flux_config(depth=2, depth_single_blocks=4)
    flow = to_torch(payload["flow"])
    inp = {k: _t(v) for k, v in payload["flux_inputs"].items()}
    res["flux_pp"] = tmodel.flux_forward(flow, cfg, **inp, pp=(meshes[2], "pipe", 2)).numpy()
    grid = Mesh({"pipe": 2, "model": 2})
    local = shard_params({k: v for k, v in flow.items() if not k.endswith("_blocks")}, grid, "model")
    for name in ("double_blocks", "single_blocks"):
        local[name] = pipeline_tp_sharding(flow[name], grid, "pipe", "model")
    res["tp_heads"] = local["double_blocks"]["img_attn"]["qkv"]["kernel"].shape
    res["flux_pp_tp"] = tmodel.flux_forward(local, cfg, **inp, tp=grid, pp=(grid, "pipe", 2)).numpy()

    # PP with recomputation: gradients of every leaf; a stage's stacked
    # leaves get its layers' rows, the others the whole gradient
    rcfg = tmodel.tiny_flux_config(depth=2, depth_single_blocks=2)
    rflow = to_torch(payload["remat_flow"])
    rin = {k: _t(v) for k, v in payload["remat_inputs"].items()}
    for leaf in tree_leaves(rflow):
        leaf.requires_grad_(True)
    out = tmodel.flux_forward(rflow, rcfg, **rin, remat=True, pp=(meshes[2], "pipe", 2))
    grads = torch.autograd.grad((out ** 2).sum(), tree_leaves(rflow))
    res["remat_grads"] = dict(zip(_paths(rflow), (g.numpy() for g in grads)))
    res["remat_stage"] = meshes[2].index("pipe")

    # FluxPipeline.enable_pipeline_parallel at depth 3 (padded to 4)
    pcfg = tmodel.tiny_flux_config(depth=3, depth_single_blocks=3)
    pipe = FluxPipeline("flux-schnell", {"flow": to_torch(payload["pipe_flow"])}, pcfg, None, None, None,
                        dtype=torch.float32)
    den = [_t(payload["denoise"][n]) for n in ("x_t", "x_ids", "txt", "txt_ids", "vec")]
    res["pipe_plain"] = pipe.denoise_latents(*den, 2, 4.0).numpy()
    pipe.enable_pipeline_parallel(meshes[2], microbatches=2)
    res["pipe_depth"] = pipe.params["flow"]["double_blocks"]["img_mod"]["kernel"].shape[0]
    res["pipe_pp"] = pipe.denoise_latents(*den, 2, 4.0).numpy()
    return res


def take3(tree):
    return {k: v[:3] for k, v in tree.items()}


def _paths(tree, prefix=""):
    """The leaves' paths in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}" if prefix else k)]
    return [prefix]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from flux_generator_tpu.models.flux import model as jmodel
    from flux_generator_tpu.parallel.pipeline import pipeline_scan as jax_pipeline_scan

    def jbody(x, p, scale):
        return x + scale * jnp.tanh(x @ p["w1"]) @ p["w2"]

    def pipe_mesh(n):
        return JMesh(np.array(jax.devices()[:n]), ("pipe",))

    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    depth, d, b = 8, 4, 4
    mlp = {"w1": jax.random.normal(ks[0], (depth, d, 2 * d)) * 0.3,
           "w2": jax.random.normal(ks[1], (depth, 2 * d, d)) * 0.3}
    x = jax.random.normal(jax.random.PRNGKey(1), (b, 3, d))
    scale = jnp.full((b, 1, 1), 0.5)
    scale_ex = jnp.arange(1, b + 1, dtype=jnp.float32).reshape(b, 1, 1) / b
    def jax_scan(stages, m, scale, x=x):
        return np.asarray(jax.jit(lambda a, p, e: jax_pipeline_scan(jbody, a, p, pipe_mesh(stages), "pipe", m, (e,)))(
            x, mlp, scale))

    # JAX's schedule computes one function at every (stages, microbatches):
    # each port case is held to it (one compile)
    want = dict.fromkeys((f"mlp_{stages}_{m}" for stages, m in MLP_CASES), jax_scan(2, 2, scale))
    want["extras"] = jax_scan(4, 4, scale_ex)
    want["odd"] = jax_scan(2, None, scale[:3], x[:3])
    grad = jax.jit(jax.grad(lambda p: jnp.sum(jax_pipeline_scan(jbody, x, p, pipe_mesh(2), "pipe", 2, (scale,)) ** 2)))(mlp)
    want["grads"] = [np.asarray(grad["w1"]), np.asarray(grad["w2"])]

    # the Flux params are drawn by the port (the JAX init runs op by op, slowly)
    cfg = jmodel.tiny_flux_config(depth=2, depth_single_blocks=4)
    flow = to_numpy(tmodel.init_flux(torch.Generator().manual_seed(0), tmodel.tiny_flux_config(depth=2, depth_single_blocks=4)))
    flux_inputs = _flux_inputs(cfg, 4, 8, 4, seed=1)
    want["flux"] = np.asarray(jax.jit(lambda p, *a: jmodel.flux_forward(p, cfg, *a))(
        flow, *(flux_inputs[k] for k in ("img", "img_ids", "txt", "txt_ids", "timesteps", "y"))))

    rcfg = jmodel.tiny_flux_config(depth=2, depth_single_blocks=2)
    rflow = to_numpy(tmodel.init_flux(torch.Generator().manual_seed(2), tmodel.tiny_flux_config()))
    remat_inputs = _flux_inputs(rcfg, 4, 4, 2, seed=3)
    args = tuple(remat_inputs[k] for k in ("img", "img_ids", "txt", "txt_ids", "timesteps", "y"))
    rgrad = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.flux_forward(p, rcfg, *args, remat=True) ** 2)))(rflow)
    want["remat_grads"] = {"/".join(k.key for k in path): np.asarray(g)
                           for path, g in jax.tree_util.tree_flatten_with_path(rgrad)[0]}

    pcfg = jmodel.tiny_flux_config(depth=3, depth_single_blocks=3)
    rng = np.random.default_rng(4)
    den = dict(x_t=rng.standard_normal((2, 4, pcfg.in_channels)).astype(np.float32),
               x_ids=np.zeros((2, 4, 3), np.int32),
               txt=rng.standard_normal((2, 4, pcfg.context_in_dim)).astype(np.float32),
               txt_ids=np.zeros((2, 4, 3), np.int32),
               vec=rng.standard_normal((2, pcfg.vec_in_dim)).astype(np.float32))
    payload = dict(mlp=jax.tree.map(np.asarray, mlp), flow=flow, remat_flow=rflow,
                   pipe_flow=to_numpy(tmodel.init_flux(torch.Generator().manual_seed(3),
                                                       tmodel.tiny_flux_config(depth=3, depth_single_blocks=3))),
                   x=np.asarray(x), scale=np.asarray(scale), scale_ex=np.asarray(scale_ex),
                   flux_inputs=flux_inputs, remat_inputs=remat_inputs, denoise=den)
    return want, spawn_ranks(_pp_checks, 4, tmp_path_factory.mktemp("pp"), payload)


@pytest.mark.parametrize("case", [f"mlp_{s}_{m}" for s, m in MLP_CASES] + ["extras", "odd"])
def test_pipeline_scan_matches_jax(ranks, case):
    want, got = ranks
    for r in got:
        np.testing.assert_allclose(r[case], want[case], atol=OUT_ATOL)


def test_pipeline_gradients_match_jax(ranks):
    """Each stage's gradients are its layers' rows of JAX's."""
    want, got = ranks
    for r in got:
        s, per = r["grad_stage"], 8 // 2
        for g, w in zip(r["grads"], want["grads"]):
            assert g.shape[0] == per
            np.testing.assert_allclose(g, w[s * per:(s + 1) * per], atol=GRAD_ATOL)


def test_bad_splits_raise(ranks):
    for r in ranks[1]:
        assert r["error_depth"] == "depth 3 not divisible by 2 pipeline stages"
        assert r["error_microbatches"] == "batch 4 not divisible by 3 microbatches"


def test_flux_forward_pipelined_and_pp_by_tp_match_jax(ranks):
    want, got = ranks
    for r in got:
        assert tuple(r["tp_heads"]) == (1, 64, 3 * 64 // 2)  # one layer a stage, half the heads a rank
        np.testing.assert_allclose(r["flux_pp"], want["flux"], atol=2e-4)
        np.testing.assert_allclose(r["flux_pp_tp"], want["flux"], atol=2e-4)


def test_pipeline_with_remat_gradients_match_jax(ranks):
    """Every leaf's gradient; a stacked leaf's on this stage's layer (one a
    stage), whose rows the stage alone computes."""
    want, got = ranks
    for r in got:
        s = r["remat_stage"]
        assert r["remat_grads"].keys() == want["remat_grads"].keys()
        for path, g in r["remat_grads"].items():
            w = want["remat_grads"][path]
            if path.split("/")[0].endswith("_blocks"):
                g, w = g[s:s + 1], w[s:s + 1]
            np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)


def test_enable_pipeline_parallel_pads_and_matches(ranks):
    for r in ranks[1]:
        assert r["pipe_depth"] == 2  # 3 layers padded to 4, two a stage
        np.testing.assert_allclose(r["pipe_pp"], r["pipe_plain"], atol=2e-4)


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("variant", ["float", "int8", "int4"])
def test_pad_stack_zero_blocks_are_identity(variant):
    cfg = tmodel.tiny_flux_config(hidden_size=128, num_heads=2, axes_dim=(16, 24, 24), context_in_dim=128,
                                  vec_in_dim=128, depth=3)
    three = tmodel.init_flux(torch.Generator().manual_seed(0), cfg)["double_blocks"]
    if variant != "float":
        kw = dict(bits=8) if variant == "int8" else dict(bits=4, pack=True)
        three = quantize_tree(three, lambda p: p["kernel"].shape[-2] % 128 == 0, **kw)
    padded, depth = pad_stack(three, 2)
    assert depth == 3 and tree_leaves(padded)[0].shape[0] == 4
    if variant == "int8":
        assert is_k_major(padded["img_attn"]["qkv"]["kernel_q"])
    if variant == "int4":
        assert torch.all(padded["img_attn"]["qkv"]["kernel_scale"][3] == 0)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((1, 8, 128)).astype(np.float32))
    txt = torch.from_numpy(rng.standard_normal((1, 4, 128)).astype(np.float32))
    vec = torch.from_numpy(rng.standard_normal((1, 128)).astype(np.float32))
    cos, sin = torch.ones((1, 12, 32)), torch.zeros((1, 12, 32))

    def run(stack, n):
        i, t = img, txt
        for layer in range(n):
            i, t = tmodel._double_block(take_layer(stack, layer), i, t, vec, cos, sin, cfg)
        return i, t

    a, b = run(three, 3), run(padded, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_one_stage_is_the_sequential_loop():
    g = torch.Generator().manual_seed(0)
    mlp = {"w1": torch.randn((3, 4, 8), generator=g) * 0.3, "w2": torch.randn((3, 8, 4), generator=g) * 0.3}
    x, scale = torch.randn((2, 2, 4), generator=g), torch.ones((2, 1, 1))
    want = x
    for i in range(3):
        want = _mlp_body(want, take_layer(mlp, i), scale)
    assert torch.equal(pipeline_scan(_mlp_body, x, mlp, Mesh({"pipe": 1}), "pipe", extras=(scale,)), want)


def test_default_microbatches_is_the_largest_divisor_up_to_the_stages():
    assert [default_microbatches(b, s) for b, s in ((4, 2), (3, 2), (8, 4), (6, 4), (1, 4))] == [2, 1, 4, 3, 1]
