"""The port's ops against the JAX package's, on the same seeded inputs (CPU,
f32). Tolerance atol 1e-5 unless stated: both sides compute in f32 and
differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.ops import attention as jattn
from flux_generator_tpu.ops import embeddings as jemb
from flux_generator_tpu.ops import linear as jlin
from flux_generator_tpu.ops import norms as jnorms
from flux_generator_tpu.ops import quant as jquant
from flux_generator_tpu.ops import rope as jrope
from flux_generator_tpu_torch.ops import attention as tattn
from flux_generator_tpu_torch.ops import embeddings as temb
from flux_generator_tpu_torch.ops import linear as tlin
from flux_generator_tpu_torch.ops import norms as tnorms
from flux_generator_tpu_torch.ops import quant as tquant
from flux_generator_tpu_torch.ops import rope as trope
from tests.test_torch_bridge import jax_to_torch

ATOL = 1e-5


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def close(t, j, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ dense

DENSE_CASES = {
    "f32": dict(),
    "int8_channel": dict(bits=8),
    "int8_grouped": dict(bits=8, group_size=32),
    "int4_channel": dict(bits=4, pack=True),
    "int4_grouped": dict(bits=4, group_size=32, pack=True),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("bias", [True, False])
def test_dense(case, bias):
    p = jlin.init_dense(jax.random.PRNGKey(1), 128, 48, bias=bias)
    kw = DENSE_CASES[case]
    if kw:
        p = jquant.quantize_dense(p, **kw)
    jx, tx = both(rand(2, 3, 5, 128))
    want = jlin.dense(p, jx)  # int4: the JAX two-half fallback on CPU
    got = tlin.dense(jax_to_torch(p), tx)
    close(got, want, atol=1e-4 if "int4" in case else ATOL)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0), (1, ((0, 1), (0, 1))), (2, ((0, 1), (0, 1)))])
def test_conv2d_nhwc(stride, padding):
    p = jlin.init_conv2d(jax.random.PRNGKey(3), 6, 10, 3)
    jx, tx = both(rand(4, 2, 9, 7, 6))
    want = jlin.conv2d(p, jx, stride=stride, padding=padding)
    got = tlin.conv2d(jax_to_torch(p), tx, stride=stride, padding=padding)
    assert got.shape == want.shape
    close(got, want)


# ------------------------------------------------------------------ norms


def _norm_params(c, seed):
    return {"scale": rand(seed, c) + 1.0, "bias": rand(seed + 1, c)}


def test_layer_norm():
    p = _norm_params(40, 5)
    jx, tx = both(rand(6, 2, 7, 40, scale=3.0) + 2.0)
    close(tnorms.layer_norm(tx, jax_to_torch(p), eps=1e-6), jnorms.layer_norm(jx, p, eps=1e-6))
    close(tnorms.layer_norm(tx), jnorms.layer_norm(jx))


def test_rms_norm():
    p = {"scale": rand(7, 40) + 1.0}
    jx, tx = both(rand(8, 2, 7, 40))
    close(tnorms.rms_norm(tx, jax_to_torch(p)), jnorms.rms_norm(jx, p))
    close(tnorms.rms_norm(tx, None, eps=1e-5), jnorms.rms_norm(jx, None, eps=1e-5))


@pytest.mark.parametrize("offset", [0.0, 1000.0])
@pytest.mark.parametrize("groups", [32, 8])
def test_group_norm(offset, groups):
    """offset=1000 with unit spread: |mean| ≫ std, where the one-pass
    formula only stays exact because of the per-group shift."""
    p = _norm_params(64, 9)
    jx, tx = both(rand(10, 2, 5, 6, 64, scale=0.5) + offset)
    close(tnorms.group_norm(tx, jax_to_torch(p), groups, eps=1e-6),
          jnorms.group_norm(jx, p, groups, eps=1e-6), atol=2e-5 if offset else ATOL)


# ------------------------------------------------------------------ rope / embeddings


def test_multi_axis_rope_and_apply():
    ids = np.random.default_rng(11).integers(0, 40, size=(2, 9, 3)).astype(np.int32)
    ids[:, :3] = 0  # text tokens: id 0 → cos 1, sin 0
    jcos, jsin = jrope.multi_axis_rope(jnp.asarray(ids), [4, 6, 6])
    tcos, tsin = trope.multi_axis_rope(torch.from_numpy(ids), [4, 6, 6])
    close(tcos, jcos)
    close(tsin, jsin)
    np.testing.assert_array_equal(tcos[:, :3].numpy(), 1.0)
    np.testing.assert_array_equal(tsin[:, :3].numpy(), 0.0)
    jx, tx = both(rand(12, 2, 9, 3, 16))
    close(trope.apply_rope(tx, tcos, tsin), jrope.apply_rope(jx, jcos, jsin))


def test_rope_rotates_interleaved_pairs():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0  # pair 0 = (1, 0)
    cos = torch.tensor([[[0.0, 1.0]]])
    sin = torch.tensor([[[1.0, 0.0]]])
    out = trope.apply_rope(x, cos, sin)
    np.testing.assert_allclose(out.flatten().numpy(), [0.0, 1.0, 0.0, 0.0])


@pytest.mark.parametrize("dim", [256, 32])
def test_timestep_embedding(dim):
    """atol 1e-4: angles reach 1000 rad (time_factor · t), where one f32 ulp
    of difference between the two libraries' exp in the frequency table moves
    the angle by ~6e-5."""
    t = np.array([1.0, 0.75, 0.5, 0.0], np.float32)
    close(temb.timestep_embedding(torch.from_numpy(t), dim),
          jemb.timestep_embedding(jnp.asarray(t), dim), atol=1e-4)


# ------------------------------------------------------------------ attention


def test_dot_product_attention_mask():
    q, k, v = (rand(s, 2, 6, 3, 8) for s in (13, 14, 15))
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    want = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask))
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask))
    close(got, want)


def test_dot_product_attention_bias_scale_one():
    q, k, v = (rand(s, 1, 5, 2, 8) for s in (16, 17, 18))
    bias = rand(19, 1, 2, 5, 5)
    want = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias), scale=1.0)
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      bias=torch.from_numpy(bias), scale=1.0)
    close(got, want)


# ------------------------------------------------------------------ quantization


def test_pack_unpack_int4_match_jax():
    q = np.random.default_rng(20).integers(-8, 8, size=(3, 16, 10)).astype(np.int8)
    jp = jquant.pack_int4(jnp.asarray(q))
    tp = tquant.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tquant.unpack_int4(tp).numpy(), q)
    np.testing.assert_array_equal(tquant.unpack_int4(tp).numpy(), np.asarray(jquant.unpack_int4(jp)))


@pytest.mark.parametrize("kw", [dict(bits=8), dict(bits=8, group_size=16), dict(bits=4, pack=True),
                                dict(bits=4, group_size=16, pack=True)],
                         ids=["int8", "int8_g16", "int4", "int4_g16"])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_dense_matches_jax(kw, stacked):
    shape = (3, 64, 24) if stacked else (64, 24)
    p = {"kernel": rand(21, *shape), "bias": rand(22, 24)}
    want = jquant.quantize_dense({k: jnp.asarray(v) for k, v in p.items()}, **kw)
    got = tquant.quantize_dense({k: torch.from_numpy(v) for k, v in p.items()}, **kw)
    assert set(got) == set(want)
    qkey = "kernel_q4" if kw.get("pack") else "kernel_q"
    np.testing.assert_array_equal(got[qkey].numpy(), np.asarray(want[qkey]).astype(got[qkey].numpy().dtype))
    np.testing.assert_array_equal(got["kernel_scale"].numpy(), np.asarray(want["kernel_scale"]))


def test_quantize_tree_default_predicate():
    tree = {"big": {"kernel": rand(23, 512, 8)}, "small": {"kernel": rand(24, 64, 8)},
            "stack": [{"kernel": rand(25, 1024, 4), "bias": rand(26, 4)}]}
    got = tquant.quantize_tree(jax_to_torch(tree), bits=4, group_size=128, pack=True)
    want = jquant.quantize_tree(jax.tree.map(jnp.asarray, tree), bits=4, group_size=128, pack=True)
    assert "kernel" in got["small"] and "kernel_q4" in got["big"]
    np.testing.assert_array_equal(got["stack"][0]["kernel_q4"].numpy(),
                                  np.asarray(want["stack"][0]["kernel_q4"]))
