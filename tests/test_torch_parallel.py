"""The port's tensor-parallel layer (parallel/distributed, mesh, sharding;
the tp path of flux_forward and t5_encode; FluxPipeline.shard) against the
JAX package's GSPMD path (tests/test_parallel.py), on the CPU.

The JAX side runs jitted on the 8 virtual CPU devices of tests/conftest.py;
the port side on 4 gloo ranks in f32, spawned once for the module (each rank
runs every check and saves its results; the tests below read them). jax is
imported inside the tests only, so a spawned rank, which imports this
module to find its function, loads no jax. atol 2e-4 is the JAX tests'
bound for a sharded forward against the whole one."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from flux_generator_tpu_torch.io.params import to_torch, tree_leaves
from flux_generator_tpu_torch.ops.linear import dense, dense_parallel
from flux_generator_tpu_torch.ops.quant import is_k_major, quantize_tree
from flux_generator_tpu_torch.parallel import distributed
from flux_generator_tpu_torch.parallel.mesh import create_mesh
from flux_generator_tpu_torch.parallel.sharding import logical_sharding, shard_dense, shard_tree, unshard_trees

WORLD = 4
TP_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work here is small: one intra-op thread, so the test
    workers running beside this one are not oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Ranks fork from a fresh server process that has imported these once
# (multiprocessing's forkserver, started clean: no jax, no threads of this
# process), so a rank does not pay torch's import again.
_PRELOAD = ["torch", "numpy", "flux_generator_tpu_torch.pipelines.flux", "flux_generator_tpu_torch.parallel.sharding",
            "flux_generator_tpu_torch.parallel.pipeline", "flux_generator_tpu_torch.parallel.ring_attention",
            "flux_generator_tpu_torch.training.dreambooth"]


def spawn_ranks(fn, world: int, tmp_path, payload) -> list:
    """Run fn(rank, world, payload) in `world` processes joined by a gloo
    group (init through a file in tmp_path, so parallel test workers never
    share a port) → each rank's returned result. The payload goes through
    a file: a large argument would hold each process's start until the one
    before had read it."""
    out = tmp_path / "ranks"
    out.mkdir()
    torch.save(payload, out / "payload.pt")
    mp.get_context("forkserver").set_forkserver_preload(_PRELOAD)
    mp.start_processes(_rank_main, args=(fn, world, str(tmp_path / "init"), str(out)), nprocs=world,
                       start_method="forkserver")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank, fn, world, init, out):
    torch.set_num_threads(1)
    distributed.initialize_multihost(init_method=f"file://{init}", num_processes=world, process_id=rank,
                                     device="cpu")
    try:
        res = fn(rank, world, torch.load(f"{out}/payload.pt", weights_only=False))
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        distributed.shutdown()


def _port_cfgs():
    from flux_generator_tpu_torch.models.clip.text import tiny_clip_config
    from flux_generator_tpu_torch.models.flux.autoencoder import tiny_ae_config
    from flux_generator_tpu_torch.models.flux.model import tiny_flux_config
    from flux_generator_tpu_torch.models.t5.t5 import tiny_t5_config

    flow = tiny_flux_config()
    return (flow, tiny_ae_config(z_channels=flow.in_channels // 4), tiny_clip_config(model_dims=flow.vec_in_dim),
            tiny_t5_config(d_model=flow.context_in_dim, num_heads=4))


def _flux_inputs(b, l_side, l_txt, seed):
    cfg = _port_cfgs()[0]
    rng = np.random.default_rng(seed)
    r, c = np.meshgrid(np.arange(l_side), np.arange(l_side), indexing="ij")
    ids = np.stack([np.zeros_like(r), r, c], -1).reshape(1, -1, 3)
    return dict(
        img=rng.standard_normal((b, l_side * l_side, cfg.in_channels)).astype(np.float32),
        img_ids=np.broadcast_to(ids, (b, l_side * l_side, 3)).astype(np.int32),
        txt=rng.standard_normal((b, l_txt, cfg.context_in_dim)).astype(np.float32),
        txt_ids=np.zeros((b, l_txt, 3), np.int32),
        timesteps=np.linspace(1.0, 0.25, b).astype(np.float32),
        y=rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32),
    )


def _rank_checks(rank, world, payload):
    from flux_generator_tpu_torch.models.flux import model as tmodel
    from flux_generator_tpu_torch.parallel.mesh import all_gather
    from flux_generator_tpu_torch.parallel.sharding import shard_params, unshard
    from flux_generator_tpu_torch.pipelines import flux as tflux

    flow_cfg, ae_cfg, clip_cfg, t5_cfg = _port_cfgs()
    params = to_torch(payload["flow"])
    inp = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in payload["inputs"].items()}
    res = {}
    mesh = create_mesh(data=1, model=world)
    local = shard_params(params, mesh)
    res["tp"] = tmodel.flux_forward(local, flow_cfg, **inp, tp=mesh).numpy()
    res["plain"] = tmodel.flux_forward(params, flow_cfg, **inp).numpy()
    # TP and ring on one axis: the heads are this rank's and whole, so the
    # attention stays head-local
    res["tp_ring"] = tmodel.flux_forward(local, flow_cfg, **inp, tp=mesh, ring=(mesh, "model", 4)).numpy()
    # control: qkv split into contiguous quarters, which cut across q, k and v
    naive = dict(local, double_blocks=dict(local["double_blocks"]))
    attn = dict(naive["double_blocks"]["img_attn"])
    full = params["double_blocks"]["img_attn"]["qkv"]
    quarter = full["kernel"].shape[-1] // world
    attn["qkv"] = {k: v[..., rank * quarter:(rank + 1) * quarter].contiguous() for k, v in full.items()}
    naive["double_blocks"]["img_attn"] = attn
    res["naive"] = tmodel.flux_forward(naive, flow_cfg, **inp, tp=mesh).numpy()
    back = unshard(local, mesh)
    res["unshard_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))

    # data parallel: each rank its rows of the batch, gathered
    dmesh = create_mesh(data=world, model=1)
    per = inp["img"].shape[0] // world
    rows = {k: v[rank * per:(rank + 1) * per] for k, v in inp.items()}
    res["dp"] = all_gather(tmodel.flux_forward(params, flow_cfg, **rows), dmesh, "data", dim=0).numpy()

    # FluxPipeline.shard: flow and T5 split, CLIP and the AE replicated
    pipe = tflux.FluxPipeline("flux-schnell", to_torch(payload["pipe"]), flow_cfg, ae_cfg, clip_cfg, t5_cfg,
                              dtype=torch.float32)
    den = {k: torch.from_numpy(v) for k, v in payload["denoise"].items()}
    t5_tok, clip_tok = (torch.from_numpy(payload[k]) for k in ("t5_tokens", "clip_tokens"))
    pipe.shard()
    res["shard_heads"] = pipe.params["flow"]["double_blocks"]["img_attn"]["qkv"]["kernel"].shape[-1]
    res["denoise"] = pipe.denoise_latents(den["x_t"], den["x_ids"], den["txt"], den["txt_ids"], den["vec"],
                                          2, 4.0).numpy()
    res["t5"] = pipe.prepare_conditioning(1, t5_tok, clip_tok)[0].numpy()
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX references, and the 4 ranks' results on the same params and
    inputs."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.models.clip.text import tiny_clip_config
    from flux_generator_tpu.models.flux import model as jmodel
    from flux_generator_tpu.models.flux.autoencoder import tiny_ae_config
    from flux_generator_tpu.models.t5.t5 import tiny_t5_config
    from flux_generator_tpu.pipelines import flux as jflux

    from flux_generator_tpu_torch.io.params import to_numpy
    from flux_generator_tpu_torch.models.clip.text import init_clip_text
    from flux_generator_tpu_torch.models.flux.model import init_flux
    from flux_generator_tpu_torch.models.t5.t5 import init_t5_encoder

    # the params are drawn by the port (the JAX init runs op by op, slowly)
    jcfg = jmodel.tiny_flux_config()
    flow_cfg, _, clip_port_cfg, t5_port_cfg = _port_cfgs()
    flow = to_numpy(init_flux(torch.Generator().manual_seed(0), flow_cfg))
    fwd = jax.jit(lambda p, *a: jmodel.flux_forward(p, jcfg, *a))
    inputs = _flux_inputs(8, 4, 4, seed=1)  # 8 rows: 2 a rank in the data-parallel check
    want = {"tp": np.asarray(fwd(flow, *(inputs[k] for k in ("img", "img_ids", "txt", "txt_ids", "timesteps",
                                                              "y"))))}

    # the pipeline's flow, T5 (4 heads, one a rank) and CLIP; no autoencoder
    # (nothing here decodes)
    clip_cfg = tiny_clip_config(model_dims=jcfg.vec_in_dim)
    t5_cfg = tiny_t5_config(d_model=jcfg.context_in_dim, num_heads=4)
    params = dict(flow=flow, ae={}, clip=to_numpy(init_clip_text(torch.Generator().manual_seed(4), clip_port_cfg)),
                  t5=to_numpy(init_t5_encoder(torch.Generator().manual_seed(5), t5_port_cfg)))
    pipe_j = jflux.FluxPipeline("flux-schnell", params, jcfg, tiny_ae_config(z_channels=jcfg.in_channels // 4),
                                clip_cfg, t5_cfg, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    b, h, w = 1, 4, 4
    den = dict(x_t=np.asarray(jflux.pack_latents(rng.standard_normal((b, h, w, pipe_j.ae_cfg.z_channels))
                                                 .astype(np.float32))),
               x_ids=np.asarray(jflux.latent_ids(b, h, w)),
               txt=rng.standard_normal((b, 4, pipe_j.flow_cfg.context_in_dim)).astype(np.float32),
               txt_ids=np.zeros((b, 4, 3), np.int32),
               vec=rng.standard_normal((b, pipe_j.flow_cfg.vec_in_dim)).astype(np.float32))
    want["denoise"] = np.asarray(pipe_j.denoise_latents(*(jnp.asarray(den[k]) for k in
                                                          ("x_t", "x_ids", "txt", "txt_ids", "vec")), 2, 4.0))
    t5_tokens = rng.integers(0, t5_cfg.vocab_size, (1, 8)).astype(np.int64)
    clip_tokens = rng.integers(0, pipe_j.clip_cfg.vocab_size, (1, 8)).astype(np.int64)
    want["t5"] = np.asarray(pipe_j.prepare_conditioning(1, jnp.asarray(t5_tokens), jnp.asarray(clip_tokens))[0])

    payload = dict(flow=flow, inputs=inputs,
                   pipe=params, denoise=den, t5_tokens=t5_tokens,
                   clip_tokens=clip_tokens)
    return want, spawn_ranks(_rank_checks, WORLD, tmp_path_factory.mktemp("tp"), payload)


def test_tp_forward_matches_jax(ranks):
    want, got = ranks
    for r in got:
        np.testing.assert_allclose(r["tp"], want["tp"], atol=TP_ATOL)
        np.testing.assert_allclose(r["plain"], want["tp"], atol=TP_ATOL)


def test_contiguous_qkv_split_misses(ranks):
    """The control: a rank's contiguous quarter of qkv is not its heads of
    q, k and v."""
    want, got = ranks
    assert all(np.abs(r["naive"] - want["tp"]).max() > 50 * TP_ATOL for r in got)


def test_tp_with_ring_on_the_same_axis_is_head_local(ranks):
    want, got = ranks
    for r in got:
        np.testing.assert_allclose(r["tp_ring"], r["plain"], atol=TP_ATOL)


def test_unshard_gathers_the_whole_tree(ranks):
    assert all(r["unshard_equal"] for r in ranks[1])


def test_dp_batch_sharded_forward_matches_jax(ranks):
    want, got = ranks
    for r in got:
        np.testing.assert_allclose(r["dp"], want["tp"], atol=TP_ATOL)


def test_pipeline_shard_denoise_and_t5_match_jax(ranks):
    want, got = ranks
    for r in got:
        assert r["shard_heads"] == 3 * 64 // WORLD  # this rank's heads of q, k and v
        np.testing.assert_allclose(r["denoise"], want["denoise"], atol=TP_ATOL)
        np.testing.assert_allclose(r["t5"], want["t5"], atol=TP_ATOL)


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("tree", ["flux", "t5", "flux_int8", "t5_int4"])
def test_logical_sharding_matches_jax(tree):
    """The JAX rule classifies by path and rank, so it runs on the port's
    trees as they are (numpy leaves)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from flux_generator_tpu.parallel.mesh import create_mesh as jax_mesh
    from flux_generator_tpu.parallel.sharding import logical_sharding as jax_logical
    from flux_generator_tpu_torch.io.params import to_numpy
    from flux_generator_tpu_torch.models.flux.model import init_flux, tiny_flux_config
    from flux_generator_tpu_torch.models.t5.t5 import init_t5_encoder, tiny_t5_config

    g = torch.Generator().manual_seed(0)
    params = init_flux(g, tiny_flux_config()) if tree.startswith("flux") else init_t5_encoder(g, tiny_t5_config())
    if tree == "flux_int8":
        params = quantize_tree(params, lambda p: True, bits=8)
    if tree == "t5_int4":
        params = quantize_tree(params, lambda p: True, bits=4, group_size=8, pack=True)

    def classify(s):
        spec = tuple(s.spec)
        return "replicated" if spec == tuple(P()) else ("col" if spec[-1] == "model" else "row")

    want = jax.tree.map(classify, jax_logical(to_numpy(params), jax_mesh(data=2, model=4)))
    assert logical_sharding(params) == want


def _dense(g, d_in, d_out, bias=True):
    p = {"kernel": torch.randn((d_in, d_out), generator=g) / d_in ** 0.5}
    if bias:
        p["bias"] = torch.randn((d_out,), generator=g)
    return p


def _tree(g):
    """Flux's and T5's split modules at widths that take groups of 128 over
    2 and 4 ranks (a stacked layer axis of 2 on the Flux modules)."""
    h, mlp = 512, 1024

    def stacked(d_in, d_out):
        return {k: torch.stack([v, v * 0.5]) for k, v in _dense(g, d_in, d_out).items()}

    return {
        "double_blocks": {"img_attn": {"qkv": stacked(h, 3 * h), "proj": stacked(h, h)},
                          "img_mlp": {"in": stacked(h, mlp), "out": stacked(mlp, h)},
                          "img_mod": stacked(h, 6 * h)},
        "single_blocks": {"linear1": stacked(h, 3 * h + mlp), "linear2": stacked(h + mlp, h)},
        "final_layer": {"linear": _dense(g, h, 64)},
        "encoder": {"layers": {"attention": {"q": _dense(g, 1024, 1024, False), "o": _dense(g, 1024, 1024, False)},
                               "dense": {"wi_0": _dense(g, 1024, 2048, False), "wo": _dense(g, 2048, 1024, False)}},
                    "rel_bias": torch.randn((8, 8), generator=g)},
    }


def _quantized(tree, variant):
    if variant == "bf16":
        return _cast(tree, torch.bfloat16)
    kw = {"int8": dict(bits=8), "int8_g128": dict(bits=8, group_size=128),
          "int4_g128": dict(bits=4, group_size=128, pack=True), "int4": dict(bits=4, pack=True)}[variant]
    return quantize_tree(tree, lambda p: True, **kw)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", ["bf16", "int8", "int8_g128", "int4_g128", "int4"])
def test_shard_unshard_round_trip(variant, n):
    tree = _quantized(_tree(torch.Generator().manual_seed(0)), variant)
    if variant == "int4_g128" and n == 4:
        # each half of an int4 shard holds whole groups of 128: T5's shards do,
        # linear2's [attention | MLP] rows over 4 ranks (384 rows) do not
        tree = {"encoder": tree["encoder"]}
    shards = [shard_tree(tree, n, r) for r in range(n)]
    qkv = shards[0]["double_blocks"]["img_attn"]["qkv"] if "double_blocks" in tree else None
    if qkv is not None and variant.startswith("int8") and variant != "int8_g128":
        assert is_k_major(qkv["kernel_q"])  # the card's int8 layout survives the split
    back = unshard_trees(shards)
    leaves, want = tree_leaves(back), tree_leaves(tree)
    assert len(leaves) == len(want)
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(leaves, want))
    assert all(x.untyped_storage().nbytes() < y.untyped_storage().nbytes()
               for x, y in zip(tree_leaves(shards[0]["encoder"]["layers"]["attention"]["q"]),
                               tree_leaves(tree["encoder"]["layers"]["attention"]["q"])))
    # the control: shards in another rank order permute heads and rows
    swapped = unshard_trees(shards[::-1])
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(swapped), want))


@pytest.mark.parametrize("variant", ["int8", "int8_g128", "int4_g128", "int4"])
@pytest.mark.parametrize("role", ["col", "row"])
def test_quantized_shards_compute_their_slice(variant, role):
    """A col shard's output is the slice of the whole dense's; the row
    shards' partial products sum to the whole product."""
    g = torch.Generator().manual_seed(1)
    p = quantize_tree({"wo": _dense(g, 1024, 512, False)}, lambda p: True,
                      **{"int8": dict(bits=8), "int8_g128": dict(bits=8, group_size=128),
                         "int4_g128": dict(bits=4, group_size=128, pack=True),
                         "int4": dict(bits=4, pack=True)}[variant])["wo"]
    x = torch.randn((3, 1024), generator=g)
    whole = dense(p, x)
    n = 4
    if role == "col":
        got = torch.cat([dense(shard_dense(p, "q", "col", n, r), x) for r in range(n)], -1)
    else:
        c = 1024 // n
        got = sum(dense(shard_dense(p, "wo", "row", n, r), x[:, r * c:(r + 1) * c]) for r in range(n))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-4, rtol=1e-5)


def test_shards_that_do_not_divide_raise():
    g = torch.Generator().manual_seed(2)
    with pytest.raises(ValueError, match="does not split"):
        shard_dense(_dense(g, 64, 3 * 64), "qkv", "col", 3, 0)
    with pytest.raises(ValueError, match="whole groups"):
        shard_dense(quantize_tree({"wo": _dense(g, 256, 64, False)}, lambda p: True, bits=4, group_size=128,
                                  pack=True)["wo"], "wo", "row", 2, 0)


def test_single_process_needs_no_group():
    """No group asked for: initialize_multihost is a no-op, process_info has
    the JAX package's keys, and a mesh of one rank runs no collective."""
    distributed.initialize_multihost(device="cpu")
    assert distributed.process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                                          "global_devices": 1}
    mesh = create_mesh(data=1, model=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("model") is None
    with pytest.raises(ValueError, match="not divisible"):
        create_mesh(model=3)
    with pytest.raises(ValueError, match="!="):
        create_mesh(data=2, model=1)


class _TwoRanks:
    """A mesh stand-in whose model axis has 2 ranks (no group: the checks
    below raise before any collective)."""

    def size(self, axis):
        return 2


def test_dense_parallel_rejects_what_it_cannot_split():
    g = torch.Generator().manual_seed(3)
    p = quantize_tree({"wo": _dense(g, 512, 64)}, lambda p: True, bits=8)["wo"]
    x = torch.randn((2, 256), generator=g)
    with pytest.raises(NotImplementedError, match="W8A8"):
        dense_parallel(p, x, _TwoRanks(), "row", w8a8="ops")
    with pytest.raises(ValueError, match="role"):
        dense_parallel(p, x, _TwoRanks(), "diagonal")
