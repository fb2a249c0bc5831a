"""int4 unpack-in-matmul: the port's plain version against the JAX Pallas
kernel (interpret mode on CPU; padded M and N included) and the JAX dense()
two-half fallback, the port's `dense` routing packed int4 as the JAX `dense`
does (the kernel where `supported`, the two-halves formulation elsewhere),
the bf16 route's tiling plan, and the CUDA kernel against the plain version on
a card. Tolerances rtol/atol 1e-4, as in tests/test_pallas_int4.py; the
dequantization of single weights bit for bit.

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


@pytest.mark.parametrize("m,k,n,group_size", [(255, 2048, 256, 128), (257, 2048, 256, None),
                                               (512, 2048, 256, 128), (64, 10240, 256, 128),
                                               (40, 2048, 328, None), (40, 2048, 328, 128)],
                         ids=["m255_g128", "m257_per_channel", "m512_g128", "k10240_g128",
                              "n328_per_channel", "n328_g128"])
def test_plain_version_matches_jax_kernel_tile_edges(m, k, n, group_size):
    """The edges of the CUDA kernel's tiles (128 or 256 rows of x, 128
    columns, 64 packed rows a stage): M one short of and one past a tile, two
    tiles, K 10240 (40 groups of 128 a half), and an N that is no multiple of
    16 (the CUDA wrapper pads it), per channel and grouped; f32 x."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.int4_matmul import int4_matmul as jax_int4

    jq, tq = _jax_quantized(14, k, n, group_size)
    x = _x(15, m, k)
    want = jax_int4(jnp.asarray(x), jq["kernel_q4"], jq["kernel_scale"], interpret=True)
    got = im.int4_matmul_reference(torch.from_numpy(x), tq["kernel_q4"], tq["kernel_scale"])
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _one_hot_rows(m, k):
    """(m, k) rows with a single 1, at columns spread over both K halves and
    every group: row i picks weight row (i · 37) mod K."""
    x = np.zeros((m, k), np.float32)
    x[np.arange(m), (np.arange(m) * 37) % k] = 1.0
    return x


@pytest.mark.parametrize("group_size", [None, 128], ids=["per_channel", "g128"])
def test_plain_version_dequantizes_as_jax_kernel_bit_for_bit(group_size):
    """One-hot bf16 rows pick single weights, so the output is the
    dequantized weight itself: bf16(f32(q) · s) grouped, bf16(q · s) per
    channel, equal to the JAX kernel's bit for bit."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.int4_matmul import int4_matmul as jax_int4

    k, n, m = 1024, 256, 96
    jq, tq = _jax_quantized(16, k, n, group_size)
    x = _one_hot_rows(m, k)
    want = jax_int4(jnp.asarray(x, jnp.bfloat16), jq["kernel_q4"], jq["kernel_scale"], interpret=True)
    got = im.int4_matmul_reference(torch.from_numpy(x).to(torch.bfloat16), tq["kernel_q4"], tq["kernel_scale"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


def _ideal(sms):
    """A card of `sms` SMs whose clusters of any split fill all but sms mod split."""
    return lambda nw, splits: sms // splits * splits


def _h100(nw, splits):
    """Blocks an H100 runs at once in clusters of 1-8 (the kernel's
    cudaOccupancyMaxActiveClusters there, times the split)."""
    return (132, 132, 117, 120, 110, 102, 105, 120)[splits - 1]


@pytest.mark.parametrize("m,k,n,capacity,want", [
    (256, 4096, 4096, _h100, (256, 3, 96)), (256, 4096, 10240, _h100, (256, 1, 80)),
    (256, 10240, 4096, _h100, (256, 3, 96)), (512, 4096, 4096, _h100, (256, 2, 128)),
    (512, 4096, 10240, _h100, (256, 2, 132)), (512, 10240, 4096, _h100, (256, 2, 128)),
    (1, 4096, 4096, _h100, (128, 3, 96)), (128, 4096, 4096, _h100, (128, 3, 96)),
    (129, 4096, 4096, _h100, (256, 3, 96)), (1, 128, 16, _h100, (128, 1, 1)),
    (256, 4096, 4096, _ideal(132), (256, 4, 128)), (512, 4096, 4096, _ideal(114), (256, 1, 64)),
    (256, 4096, 4096, _ideal(1), (256, 1, 1))], ids=lambda v: "" if callable(v) else None)
def test_plan_fills_the_card(m, k, n, capacity, want):
    """The bf16 route's (x rows a tile, K splits, grid), counted by hand from
    its cost, ⌈tiles / clusters⌉ · (⌈blocks / splits⌉ + 10 · (splits − 1) /
    splits). At M 256 and 4096², 32 tiles of 32 blocks of packed rows: on the
    H100, 39 clusters of 3 take every tile at once (cost 17.67), against 21
    for 2 splits and two rounds of 30 clusters of 4 (31); a card with room
    for 33 clusters of 4 takes 4 (15.5). At N 10240 the 80 tiles run unsplit
    in one round (32; 2 splits take two rounds, 42). At M 512 and 4096² on
    114 SMs, 64 tiles fit unsplit (32) and 2 splits would take two rounds of
    57 clusters (42). The grid is a multiple of the split, never past the
    card or the tiles."""
    got = im.plan(m, n, k, capacity)
    assert got == want
    nw, splits, grid = got
    assert grid % splits == 0 and grid <= max(capacity(nw, splits), 1) and splits <= -(-k // 2 // im.BLOCK_ROWS)


def test_plan_takes_128_rows_for_row_scales():
    """Group sizes that are no multiple of 64 take tiles of 128 rows at any M:
    at M 256 and 4096² on the H100, 64 tiles; 2 splits fill 128 blocks in one
    round (cost 21), unsplit 32, 3 splits two rounds of 39 clusters (35.33)."""
    assert im.plan(256, 4096, 4096, _h100, row_scales=True) == (128, 2, 128)
    assert im.plan(256, 4096, 4096, _h100) == (256, 3, 96)


def test_ragged_n_is_padded_as_the_tpu_wrapper_pads():
    """The CUDA route's weights for an N that is no multiple of 16: rows
    padded to the next multiple with 0x88 bytes (both nibbles 8: q = 0)."""
    q4 = torch.from_numpy(np.random.default_rng(17).integers(0, 256, (64, 200), dtype=np.uint8))
    w, pitch = im._pad_n(q4)
    assert pitch == 208 and w.shape == (64, 208)
    assert torch.equal(w[:, :200], q4) and bool((w[:, 200:] == 0x88).all())
    same, pitch = im._pad_n(q4[:, :192].contiguous())
    assert pitch == 192 and same.shape == (64, 192)


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
                                      (256, 4096, 200, 128), (17, 1024, 201, None),
                                      (64, 4096, 4096, 128), (65, 2048, 1024, None),
                                      (255, 4096, 4096, 128), (257, 4096, 4096, None),
                                      (512, 4096, 10240, 128), (512, 10240, 4096, 128),
                                      (64, 1216, 200, 32), (5, 192, 48, 3), (3, 64, 16, None)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cuda_kernel_matches_plain_version(m, k, n, gs, dtype, monkeypatch):
    """Kernel against the plain version on the same inputs and weights; both
    accumulate in f32. bf16: against the plain version in f32, so the bound
    is the bf16 rounding of the output, rtol 1e-2 of the output's largest
    magnitude. f32 (CUDA-core FMAs, no TF32): 1e-5 of it, f32 sums in
    another order. Cases at the bf16 route's tile edges (M 64, 65, 255, 257,
    512; a ragged N; K 10240), K splits of 1 to 8, group sizes that are no
    multiple of a stage (32, and 3 with a K half of 96: a partial block)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,gs", [(256, 4096, 4096, None), (256, 4096, 4096, 128),
                                      (256, 10240, 4096, 128), (64, 1216, 200, 32)],
                         ids=["per_channel", "g128", "k10240_g128", "n200_g32"])
def test_cuda_kernel_dequantizes_bit_for_bit(m, k, n, gs, monkeypatch):
    """One-hot bf16 rows pick single weights, so the kernel's output is the
    dequantized weight itself and must equal the plain version's bit for bit:
    bf16(f32(q) · s) grouped, q · s in f32 then bf16 per channel. A control
    that rounds q and s to bf16 before their product must differ somewhere
    (the 1e-2 · max|ref| bound of the test above cannot tell the two apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    w = torch.randn((k, n), generator=g, device=dev) / k ** 0.5
    p = quantize_dense({"kernel": w}, bits=4, group_size=gs, pack=True)
    x = torch.from_numpy(_one_hot_rows(m, k)).to(dev, torch.bfloat16)
    out = im.int4_matmul(x, p["kernel_q4"], p["kernel_scale"])
    ref = im.int4_matmul_reference(x, p["kernel_q4"], p["kernel_scale"])
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    lo, hi = im._halves(p["kernel_q4"])
    q = torch.cat([lo, hi])[(torch.arange(m, device=dev) * 37) % k]  # the picked rows' q
    s = p["kernel_scale"]
    s = s.repeat_interleave(k // s.shape[0], dim=0)[(torch.arange(m, device=dev) * 37) % k] if s.dim() == 2 else s
    control = (q.to(torch.bfloat16).float() * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert not torch.equal(control, ref)
