"""int4 unpack-in-matmul: the port's plain version against the JAX Pallas
kernel (interpret mode on CPU) and the JAX dense() two-half fallback, and the
CUDA kernel against the plain version on a card. Tolerances rtol/atol 1e-4,
as in tests/test_pallas_int4.py.

jax is imported inside the tests that use it, so the `cuda` case runs on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_int4_matmul.py`."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import int4_matmul as im
from flux_generator_tpu_torch.ops.quant import quantize_dense


def _jax_quantized(seed, k, n, group_size):
    import jax

    from flux_generator_tpu.ops.linear import init_dense
    from flux_generator_tpu.ops.quant import quantize_dense as jax_quantize_dense

    p = init_dense(jax.random.PRNGKey(seed), k, n, bias=False)
    q = jax_quantize_dense(p, bits=4, group_size=group_size, pack=True)
    return q, {name: torch.from_numpy(np.array(a)) for name, a in q.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_plain_version_matches_jax_kernel_per_channel():
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.int4_matmul import int4_matmul as jax_int4

    K, N, M = 2048, 640, 96
    jq, tq = _jax_quantized(0, K, N, None)
    x = _x(1, M, K)
    want = jax_int4(jnp.asarray(x), jq["kernel_q4"], jq["kernel_scale"], interpret=True)
    got = im.int4_matmul_reference(torch.from_numpy(x), tq["kernel_q4"], tq["kernel_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("group_size", [64, 128])
@pytest.mark.parametrize("lead", [(2, 7), (2,)], ids=["lead_2x7", "m2"])
def test_plain_version_matches_jax_dense_grouped(group_size, lead):
    import jax.numpy as jnp

    from flux_generator_tpu.ops.linear import dense as jax_dense

    K, N = 2048, 512
    jq, tq = _jax_quantized(2, K, N, group_size)
    x = _x(3, *lead, K)
    want = jax_dense(jq, jnp.asarray(x))
    got = im.int4_matmul(torch.from_numpy(x), tq["kernel_q4"], tq["kernel_scale"])
    assert got.shape == (*lead, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_without_counting():
    p = quantize_dense({"kernel": torch.from_numpy(_x(4, 256, 64))}, bits=4, group_size=64, pack=True)
    x = torch.from_numpy(_x(5, 3, 256))
    before = im.launches
    got = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
    assert torch.equal(got, im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"]))
    assert im.launches == before


def test_grouped_scales_follow_the_split_layout():
    """Row r + K/2 (high nibble) takes group (r + K/2) / gs: the first g/2
    scale rows belong to the low half."""
    K, N, gs = 128, 16, 32
    w = torch.from_numpy(_x(6, K, N))
    p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
    x = torch.eye(K)
    got = im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"])  # = dequantized W
    np.testing.assert_allclose(got.numpy(), w.numpy(), atol=p["kernel_scale"].max().item() / 2 + 1e-6)


@pytest.mark.parametrize("bad", ["f32", "k_not_64", "n_not_16", "bad_groups", "scale_dtype"])
def test_kernel_argument_checks_raise(bad):
    K, N = 256, 64
    x = torch.zeros(4, K, dtype=torch.bfloat16)
    q4 = torch.zeros(K // 2, N, dtype=torch.uint8)
    scale = torch.ones(K // 64, N)
    if bad == "f32":
        x = x.float()
    elif bad == "k_not_64":
        x = torch.zeros(4, 96, dtype=torch.bfloat16)
        q4 = torch.zeros(48, N, dtype=torch.uint8)
        scale = torch.ones(N)
    elif bad == "n_not_16":
        q4 = torch.zeros(K // 2, 24, dtype=torch.uint8)
        scale = torch.ones(24)
    elif bad == "bad_groups":
        scale = torch.ones(3, N)
    elif bad == "scale_dtype":
        scale = scale.to(torch.bfloat16)
    with pytest.raises(ValueError):
        im._check_cuda_args(x, q4, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,gs", [(256, 4096, 4096, 128), (256, 4096, 10240, 128),
                                      (256, 10240, 4096, 128), (256, 4096, 4096, None),
                                      (5, 1024, 400, 64), (300, 2048, 640, None),
                                      (1, 128, 16, 64)])
def test_cuda_kernel_matches_plain_version(m, k, n, gs):
    """bf16 kernel against the plain version in f32 on the same inputs and
    weights; both accumulate in f32, so the bound is the bf16 rounding of
    the output: rtol 1e-2 of the output's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = im.launches
    out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
    torch.cuda.synchronize()
    assert im.launches == before + 1
    ref = im.int4_matmul_reference(x.float(), p["kernel_q4"], p["kernel_scale"])
    err = (out.float() - ref).abs().max().item()
    assert err <= 1e-2 * ref.abs().max().item()
