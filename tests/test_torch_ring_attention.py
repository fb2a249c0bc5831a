"""Ring attention (parallel/ring_attention.py) against the JAX package's
(tests/test_ring_attention.py) on the CPU: 2 and 4 gloo ranks in f32 (one
spawn of 4; the 2-rank ring is a mesh of ranks 0 and 1) against JAX's ring on
a 2- and 4-device mesh, with a RoPE prefix; the fold-and-merge against the
plain attention, with a dropped shard as the control; and
FluxPipeline.enable_ring_attention through a tiny Flux denoise. atol 2e-5
and 3e-5 are the JAX tests' bounds."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels.flash_attention import flash_attention_reference
from flux_generator_tpu_torch.parallel.ring_attention import fold_and_merge
from tests.test_torch_parallel import spawn_ranks

RING_ATOL = 2e-5
B, L, H, D = 2, 32, 2, 8
from tests.test_torch_parallel import _one_thread  # noqa: F401 (autouse)


def _ring_checks(rank, world, payload):
    from flux_generator_tpu_torch.io.params import to_torch
    from flux_generator_tpu_torch.models.flux.model import tiny_flux_config
    from flux_generator_tpu_torch.parallel.mesh import Mesh, create_mesh
    from flux_generator_tpu_torch.parallel.ring_attention import ring_attention_rope
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline

    q, k, v, cos, sin = (torch.from_numpy(payload[n]) for n in ("q", "k", "v", "cos", "sin"))
    mesh4 = create_mesh(data=1, model=4)
    mesh2 = Mesh({"model": 2}, ranks=[0, 1])  # every rank builds it; ranks 2 and 3 sit out
    res = {"ring4": ring_attention_rope(q, k, v, cos, sin, mesh4, "model").numpy()}
    if mesh2.coords is not None:
        res["ring2"] = ring_attention_rope(q, k, v, cos, sin, mesh2, "model").numpy()

    pipe = FluxPipeline("flux-schnell", {"flow": to_torch(payload["flow"])}, tiny_flux_config(), None, None, None,
                        dtype=torch.float32)
    den = [torch.from_numpy(payload["denoise"][n]) for n in ("x_t", "x_ids", "txt", "txt_ids", "vec")]
    res["plain"] = pipe.denoise_latents(*den, 2, 4.0).numpy()
    pipe.enable_ring_attention(mesh4, threshold=80)  # 64 image + 16 text tokens, 20 a rank
    res["ring"] = pipe.denoise_latents(*den, 2, 4.0).numpy()
    pipe.enable_ring_attention(mesh4, threshold=10_000)  # the switch is length-gated
    res["below"] = pipe.denoise_latents(*den, 2, 4.0).numpy()
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flux_generator_tpu_torch.io.params import to_numpy
    from flux_generator_tpu_torch.models.flux.model import init_flux, tiny_flux_config
    from flux_generator_tpu.ops.rope import apply_rope, rope_cos_sin
    from flux_generator_tpu.parallel.mesh import create_mesh
    from flux_generator_tpu.parallel.ring_attention import ring_attention

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    cos, sin = (np.asarray(t) for t in rope_cos_sin(jnp.broadcast_to(jnp.arange(L, dtype=jnp.float32), (B, L)), D))
    qr, kr = apply_rope(jnp.asarray(q), cos, sin), apply_rope(jnp.asarray(k), cos, sin)
    want = {}
    for n in (2, 4):
        mesh = create_mesh(data=1, model=n, devices=jax.devices()[:n])
        spec = NamedSharding(mesh, P(None, "model"))
        ring = jax.jit(lambda a, b, c, mesh=mesh: ring_attention(a, b, c, mesh))
        want[f"ring{n}"] = np.asarray(ring(*(jax.device_put(x, spec) for x in (qr, kr, jnp.asarray(v)))))

    cfg = tiny_flux_config()
    b, h, w = 1, 16, 16  # 64 packed image tokens
    den = dict(x_t=rng.standard_normal((b, h * w // 4, cfg.in_channels)).astype(np.float32),
               x_ids=np.stack(np.meshgrid(np.zeros(1), np.arange(h // 2), np.arange(w // 2), indexing="ij"), -1)
               .reshape(1, -1, 3).astype(np.int64),
               txt=rng.standard_normal((b, 16, cfg.context_in_dim)).astype(np.float32),
               txt_ids=np.zeros((b, 16, 3), np.int64),
               vec=rng.standard_normal((b, cfg.vec_in_dim)).astype(np.float32))
    payload = dict(q=q, k=k, v=v, cos=cos, sin=sin, denoise=den,
                   flow=to_numpy(init_flux(torch.Generator().manual_seed(0), cfg)))
    return want, spawn_ranks(_ring_checks, 4, tmp_path_factory.mktemp("ring"), payload)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_with_rope_prefix_matches_jax(ranks, n):
    want, got = ranks
    members = got if n == 4 else got[:2]
    for r in members:
        np.testing.assert_allclose(r[f"ring{n}"], want[f"ring{n}"], atol=RING_ATOL)
    assert all(f"ring{n}" not in r for r in got[n:])


def test_enable_ring_attention_through_a_flux_denoise(ranks):
    for r in ranks[1]:
        np.testing.assert_allclose(r["ring"], r["plain"], atol=3e-5, rtol=3e-5)
        assert not np.array_equal(r["ring"], r["plain"])  # the ring ran
        np.testing.assert_array_equal(r["below"], r["plain"])


def _qkv(seed, b=2, length=64, h=2, d=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, length, h, d), generator=g) for _ in range(3))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_fold_and_merge_matches_plain_attention(n_shards):
    q, k, v = _qkv(n_shards)
    want, _ = flash_attention_reference(q, k, v)
    got = fold_and_merge(q, list(zip(k.chunk(n_shards, 1), v.chunk(n_shards, 1))))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=RING_ATOL)


def test_fold_and_merge_of_one_fold_is_the_fold():
    q, k, v = _qkv(7)
    assert torch.equal(fold_and_merge(q, [(k, v)]), flash_attention_reference(q, k, v)[0])


def test_fold_and_merge_with_a_dropped_shard_misses():
    q, k, v = _qkv(5)
    want, _ = flash_attention_reference(q, k, v)
    shards = list(zip(k.chunk(4, 1), v.chunk(4, 1)))
    got = fold_and_merge(q, shards[:-1])
    assert (got - want).abs().max() > 100 * RING_ATOL
