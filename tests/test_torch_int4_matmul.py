"""int4 unpack-in-matmul: the port's plain version against the JAX Pallas
kernel (interpret mode on CPU; padded M and N included) and the JAX dense()
two-half fallback, the port's `dense` routing packed int4 as the JAX `dense`
does (the kernel where `supported`, the two-halves formulation elsewhere),
and the CUDA kernel against the plain version on a card. Tolerances rtol/atol
1e-4, as in tests/test_pallas_int4.py.

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


@pytest.mark.parametrize("m,n,group_size", [(1, 200, None), (17, 640, 128), (17, 200, 64)],
                         ids=["m1_n200_per_channel", "m17_grouped", "m17_n200_grouped"])
def test_plain_version_matches_jax_kernel_padded(m, n, group_size):
    """The TPU wrapper pads M with zero rows and N with 0x88 bytes (and zero
    scales) to its blocks and slices the result: the plain version, which
    pads nothing, gives the same numbers at ragged M and N (f32 x)."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.int4_matmul import int4_matmul as jax_int4

    K = 2048
    jq, tq = _jax_quantized(8, K, n, group_size)
    x = _x(9, m, K)
    want = jax_int4(jnp.asarray(x), jq["kernel_q4"], jq["kernel_scale"], interpret=True)
    got = im.int4_matmul_reference(torch.from_numpy(x), tq["kernel_q4"], tq["kernel_scale"])
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,group_size,dtype", [(128, None, "f32"), (96, None, "f32"), (192, 32, "f32"),
                                                 (128, None, "bf16"), (192, 32, "bf16")])
def test_dense_unsupported_k_matches_jax_dense(k, group_size, dtype):
    """Where the TPU kernel does not take K (`supported` is false), both
    `dense`s run the two-halves formulation in x's dtype: f32 to 1e-5, bf16
    to one bf16 step (2^-8) of max|y| (each half's product rounds once)."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.linear import dense as jax_dense
    from flux_generator_tpu.ops.pallas.int4_matmul import supported as jax_supported
    from flux_generator_tpu_torch.ops.linear import dense

    jq, tq = _jax_quantized(10, k, 48, group_size)
    assert not jax_supported(k, jq["kernel_scale"]) and not im.supported(k, tq["kernel_scale"])
    x = _x(11, 5, k)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_dense(jq, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = dense(tq, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "f32" else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("k,group_size,kernel", [(2048, 128, True), (2048, None, True), (512, 256, True),
                                                 (128, None, False), (1536, 192, False)])
def test_dense_routes_int4_as_jax_does(monkeypatch, k, group_size, kernel):
    """`dense` calls the int4 kernel's wrapper exactly where the JAX package's
    `supported` holds, with the same K and scales."""
    from flux_generator_tpu.ops.pallas.int4_matmul import supported as jax_supported
    from flux_generator_tpu_torch.ops import linear

    jq, tq = _jax_quantized(12, k, 32, group_size)
    assert jax_supported(k, jq["kernel_scale"]) == kernel == im.supported(k, tq["kernel_scale"])
    calls = []
    real = im.int4_matmul
    monkeypatch.setattr(im, "int4_matmul", lambda *a: calls.append(a[0].shape) or real(*a))
    linear.dense(tq, torch.from_numpy(_x(13, 3, k)))
    assert calls == ([(3, k)] if kernel else [])


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


@pytest.mark.parametrize("bad", ["f16", "k_not_64", "misaligned", "bad_groups", "scale_dtype"])
def test_kernel_argument_checks_raise(bad):
    K, N = 256, 64
    x = torch.zeros(4, K, dtype=torch.bfloat16)
    q4 = torch.zeros(K // 2, N, dtype=torch.uint8)
    scale = torch.ones(K // 64, N)
    if bad == "f16":
        x = x.half()
    elif bad == "k_not_64":
        x = torch.zeros(4, 96, dtype=torch.bfloat16)
        q4 = torch.zeros(48, N, dtype=torch.uint8)
        scale = torch.ones(N)
    elif bad == "misaligned":
        x = torch.zeros(4 * K + 1, dtype=torch.bfloat16)[1:].view(4, K)
    elif bad == "bad_groups":
        scale = torch.ones(3, N)
    elif bad == "scale_dtype":
        scale = scale.to(torch.bfloat16)
    with pytest.raises(ValueError):
        im._check_cuda_args(x, q4, scale)


@pytest.mark.parametrize("case", ["f32", "n_not_16", "n_odd", "m_1"])
def test_kernel_takes_what_the_tpu_wrapper_takes(case):
    """f32 activations, any N and any M pass the kernel's checks, as the TPU
    wrapper takes them (it pads M and N; the kernel masks)."""
    K, M, N = 256, 4, 64
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    N = {"n_not_16": 24, "n_odd": 201}.get(case, N)
    M = 1 if case == "m_1" else M
    im._check_cuda_args(torch.zeros(M, K, dtype=dtype), torch.zeros(K // 2, N, dtype=torch.uint8),
                        torch.ones(K // 64, N))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,gs", [(256, 4096, 4096, 128), (256, 4096, 10240, 128),
                                      (256, 10240, 4096, 128), (256, 4096, 4096, None),
                                      (5, 1024, 400, 64), (300, 2048, 640, None),
                                      (1, 128, 16, 64), (1, 4096, 4096, 128), (17, 4096, 4096, 128),
                                      (256, 4096, 200, 128), (17, 1024, 201, None)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cuda_kernel_matches_plain_version(m, k, n, gs, dtype, monkeypatch):
    """Kernel against the plain version on the same inputs and weights; both
    accumulate in f32. bf16: against the plain version in f32, so the bound
    is the bf16 rounding of the output, rtol 1e-2 of the output's largest
    magnitude. f32 (CUDA-core FMAs, no TF32): 1e-5 of it, f32 sums in
    another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
    x = torch.randn((m, k), generator=g, device=dev)
    x = x.to(torch.bfloat16) if dtype == "bf16" else x
    before = im.launches
    out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
    torch.cuda.synchronize()
    assert im.launches == before + 1 and out.dtype == x.dtype and out.shape == (m, n)
    ref = im.int4_matmul_reference(x.float(), p["kernel_q4"], p["kernel_scale"])
    err = (out.float() - ref).abs().max().item()
    assert err <= (1e-2 if dtype == "bf16" else 1e-5) * ref.abs().max().item()
