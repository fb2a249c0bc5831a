"""W8A8: the fused W8A8 matmul (kernel G) and the row quantizer (kernel H),
their plain versions against the JAX Pallas kernels (interpret mode on CPU),
`dense(..., w8a8=route)` against the JAX `dense` under `set_w8a8(True)`, and
the CUDA kernels against the plain versions on a card.

jax is imported inside the tests that use it, so the `cuda` cases run on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_w8a8.py`."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops import linear as tl
from flux_generator_tpu_torch.ops.kernels import w8a8_matmul as tw

# the JAX package's FGT_W8A8_IMPL formulation of each route
ROUTES = {"ops": "xla", "rows": "pq", "fused": "pallas"}
# kernel G's dense shapes in a Flux-schnell 512² request (M, K, N): linear1,
# linear2, image mlp0, mlp2, qkv, proj, text qkv, proj, mlp0, mlp2, txt_in,
# the final linear
G_SHAPES = [(1280, 3072, 21504), (1280, 15360, 3072), (1024, 3072, 12288), (1024, 12288, 3072),
            (1024, 3072, 9216), (1024, 3072, 3072), (256, 3072, 9216), (256, 3072, 3072), (256, 3072, 12288),
            (256, 12288, 3072), (256, 4096, 3072), (1024, 3072, 64)]
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def _mk(seed, m, k, n, lead=()):
    """x (…, M, K) f32 and an int8 per-channel (K, N) weight, as
    tests/test_w8a8.py builds them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    ws = (np.abs(w).max(0) / 127).astype(np.float32)
    return x, np.round(w / ws).astype(np.int8), ws


def _as(x, dtype):
    """numpy f32 → (jax array, torch tensor) in `dtype` ("f32" or "bf16")."""
    import jax.numpy as jnp

    xj = jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    return xj, xt if dtype == "f32" else xt.to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_quantize_rows_plain_matches_jax(dtype, lead):
    """Bytes equal; scales at rtol 1e-6 (the JAX test's tolerance; they agree
    exactly here: the same f32 amax, multiply and reciprocal)."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.w8a8_matmul import quantize_rows as jax_quantize_rows

    x, _, _ = _mk(3, 20, 768, 1, lead)
    x[..., 0, :] = 0.0  # an all-zero row keeps the 1e-12 floor
    xj, xt = _as(x, dtype)
    qj, sj = jax_quantize_rows(xj, interpret=True)
    qt, st = tw.quantize_rows(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (*lead, 20, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj.astype(jnp.float32)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 1024, 256), (200, 1536, 700), (16, 512, 128)])
def test_w8a8_matmul_plain_matches_jax(shape, dtype):
    """The shapes of tests/test_w8a8.py. Both sides quantize identically and
    take exact integer dots; only the f32 fold of several K blocks may round
    differently (XLA may contract it into fused multiply-adds): rtol 1e-6 of
    max|ref| in f32, and at most one bf16 step (2^-8 of max|ref|) in bf16."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.w8a8_matmul import w8a8_matmul as jax_w8a8

    m, k, n = shape
    x, wq, ws = _mk(0, m, k, n)
    xj, xt = _as(x, dtype)
    want = np.asarray(jax_w8a8(xj, jnp.asarray(wq), jnp.asarray(ws), interpret=True).astype(jnp.float32))
    got = tw.w8a8_matmul(xt, torch.from_numpy(wq), torch.from_numpy(ws))
    assert got.dtype == xt.dtype and got.shape == (m, n)
    tol = (1e-6 if dtype == "f32" else 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_w8a8_matmul_leading_dims_and_zero_rows():
    """Leading dims reshape exactly; all-zero rows give exact zeros (the
    1e-12 floor keeps the scale finite), as in the JAX tests."""
    x, wq, ws = _mk(1, 96, 1024, 384)
    x[5] = 0.0
    w, s = torch.from_numpy(wq), torch.from_numpy(ws)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    flat = tw.w8a8_matmul(xt, w, s)
    lead = tw.w8a8_matmul(xt.reshape(4, 24, 1024), w, s)
    assert lead.shape == (4, 24, 384) and lead.dtype == torch.bfloat16
    assert torch.equal(lead.reshape(96, 384), flat)
    assert torch.equal(flat[5], torch.zeros(384, dtype=torch.bfloat16))


def test_supported_guards():
    assert tw.pick_bk(1536) == 512 and tw.pick_bk(768) == 256 and tw.pick_bk(384) == 128
    assert not tw.supported(100, torch.ones(64))          # K does not tile
    assert not tw.supported(1024, torch.ones(8, 64))      # grouped scales
    assert tw.supported(1024, torch.ones(64))


def _dense_pair(x, wq, ws, *, bias=True, lora=False, grouped=False):
    """The same dense params for JAX and for the port."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    k, n = wq.shape
    p = {"kernel_q": wq, "kernel_scale": ws}
    if grouped:
        p["kernel_scale"] = np.repeat(ws[None], k // 128, 0) * (1 + 0.1 * rng.random((k // 128, n))
                                                                ).astype(np.float32)
    if bias:
        p["bias"] = (np.arange(n) * 0.01).astype(np.float32)
    if lora:
        p["lora_a"] = (0.05 * rng.standard_normal((k, 4))).astype(np.float32)
        p["lora_b"] = (0.05 * rng.standard_normal((4, n))).astype(np.float32)
    return ({key: jnp.asarray(v) for key, v in p.items()},
            {key: torch.from_numpy(v) for key, v in p.items()})


def _jax_dense(monkeypatch, impl, p, x):
    from flux_generator_tpu.ops import linear as jl

    monkeypatch.setenv("FGT_W8A8_IMPL", impl)
    jl.set_w8a8(True)
    try:
        return jl.dense(p, x)
    finally:
        jl.set_w8a8(None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("extra", ["bias", "lora"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_dense_route_matches_jax(monkeypatch, route, extra, dtype):
    """Each route against the JAX `dense` with the matching FGT_W8A8_IMPL
    (its Pallas kernels in interpret mode): the same quantization, exact
    integer dots and the same rounding order in x's dtype, so the outputs
    are equal; atol 1e-6 of max|ref| leaves room for the f32 bias and LoRA
    additions' order."""
    import jax.numpy as jnp

    x, wq, ws = _mk(5, 48, 512, 256, lead=(2,))
    pj, pt = _dense_pair(x, wq, ws, lora=extra == "lora")
    xj, xt = _as(x, dtype)
    want = np.asarray(_jax_dense(monkeypatch, ROUTES[route], pj, xj).astype(jnp.float32))
    got = tl.dense(pt, xt, w8a8=route)
    assert got.dtype == xt.dtype and got.shape == (2, 48, 256)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("route", list(ROUTES))
def test_grouped_scales_keep_the_weight_only_path(monkeypatch, route):
    """As JAX's test_grouped_quant_ignores_w8a8: grouped int8 scales
    dequantize the weight whatever the route."""
    import jax.numpy as jnp

    x, wq, ws = _mk(6, 32, 512, 128)
    pj, pt = _dense_pair(x, wq, ws, grouped=True)
    want = np.asarray(_jax_dense(monkeypatch, ROUTES[route], pj, jnp.asarray(x)))
    got = tl.dense(pt, torch.from_numpy(x), w8a8=route)
    assert torch.equal(got, tl.dense(pt, torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", list(ROUTES))
def test_unpacked_int4_keeps_the_weight_only_path(monkeypatch, route):
    """Unpacked int4 per channel — the JAX int4 dtype, held as int8 across the
    bridge with its INT4_MARK, and the port's own quantize_tree(bits=4) —
    takes no W8A8 branch: every route equals the JAX `dense` under
    set_w8a8(True), which keeps int4 weight-only (`linear.py:145`).
    Tolerance as the grouped case: f32 dequant on both sides."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.ops.quant import quantize_tree as jax_quantize_tree
    from flux_generator_tpu_torch.io.params import take_layer, to_torch
    from flux_generator_tpu_torch.ops.quant import INT4_MARK, quantize_tree

    rng = np.random.default_rng(10)
    x = rng.standard_normal((32, 512)).astype(np.float32)
    w = rng.standard_normal((2, 512, 128)).astype(np.float32)  # a stack of two layers
    pj = jax_quantize_tree({"kernel": jnp.asarray(w)}, predicate=lambda p: True, bits=4)
    assert pj["kernel_q"].dtype == jnp.int4
    stack = to_torch(jax.tree.map(np.asarray, pj))
    own = quantize_tree({"kernel": torch.from_numpy(w)}, lambda p: True, bits=4)
    assert stack["kernel_q"].dtype == own["kernel_q"].dtype == torch.int8
    assert stack[INT4_MARK].shape == own[INT4_MARK].shape == (2,)
    xt = torch.from_numpy(x)
    for layer in range(2):
        pjl = jax.tree.map(lambda a, i=layer: a[i], pj)
        want = np.asarray(_jax_dense(monkeypatch, ROUTES[route], pjl, jnp.asarray(x)))
        for pt in (take_layer(stack, layer), take_layer(own, layer)):
            got = tl.dense(pt, xt, w8a8=route)
            assert torch.equal(got, tl.dense(pt, xt))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["rows", "fused"])
def test_few_rows_and_odd_k_take_the_ops_formulation(monkeypatch, route):
    """Fewer than 16 activation rows (the modulations' M = 1), and for
    "fused" a K that no block tiles, take JAX's XLA formulation ("ops"),
    equal to the JAX run of the same route."""
    import jax.numpy as jnp

    for m, k in ((1, 512), (8, 512)) + (((32, 320),) if route == "fused" else ()):
        x, wq, ws = _mk(8, m, k, 64)
        pj, pt = _dense_pair(x, wq, ws)
        want = np.asarray(_jax_dense(monkeypatch, ROUTES[route], pj, jnp.asarray(x)))
        got = tl.dense(pt, torch.from_numpy(x), w8a8=route)
        assert torch.equal(got, tl.dense(pt, torch.from_numpy(x), w8a8="ops"))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_w8a8_argument_is_checked_and_leaves_other_tiers_alone():
    x, wq, ws = _mk(9, 16, 512, 64)
    _, pt = _dense_pair(x, wq, ws)
    with pytest.raises(ValueError):
        tl.dense(pt, torch.from_numpy(x), w8a8="pallas")
    p = {"kernel": torch.from_numpy(np.random.default_rng(1).standard_normal((512, 64)).astype(np.float32))}
    xt = torch.from_numpy(x)
    assert torch.equal(tl.dense(p, xt, w8a8="fused"), tl.dense(p, xt))


def test_int8_dot_is_exact_past_float_precision():
    """The full-K int32 product at K 15360 (the single blocks' linear2),
    where f32 sums of up to 2.5e8 would round."""
    rng = np.random.default_rng(10)
    a = rng.integers(-127, 128, (3, 15360)).astype(np.int8)
    b = rng.integers(-127, 128, (15360, 5)).astype(np.int8)
    a[0] = 127
    b[:, 0] = 127
    got = tl.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_jax_w8a8_tree_crosses_the_bridge_unchanged():
    """An int8 per-channel flow tree from the JAX quantizer keeps int8
    `kernel_q` (values unchanged, stored K-contiguous) and f32 (layers, N)
    `kernel_scale` leaves, and its layer runs every route."""
    import jax

    from flux_generator_tpu.models.flux.model import init_flux, tiny_flux_config
    from flux_generator_tpu.ops.quant import quantize_tree
    from flux_generator_tpu_torch.io.params import take_layer, to_numpy, to_torch

    tree = quantize_tree(init_flux(jax.random.PRNGKey(0), tiny_flux_config()), lambda p: True, bits=8)
    want = jax.tree.map(np.asarray, tree)
    t = to_torch(want)
    for a, b in zip(jax.tree.leaves(to_numpy(t)), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    qkv = t["double_blocks"]["img_attn"]["qkv"]
    assert qkv["kernel_q"].dtype == torch.int8 and qkv["kernel_scale"].dtype == torch.float32
    assert qkv["kernel_scale"].shape == (2, 192)
    assert qkv["kernel_q"].stride() == (64 * 192, 1, 64)  # stored K-contiguous, as ops.quant does
    layer = take_layer(t["double_blocks"], 0)["img_attn"]["qkv"]
    x = torch.randn(2, 16, 64)
    ys = [tl.dense(layer, x, w8a8=r) for r in ROUTES]
    assert all(y.shape == (2, 16, 192) and torch.isfinite(y).all() for y in ys)


def test_k_major_relayout_keeps_values_and_routes():
    """The quantizer stores int8 per-channel kernels (stacked ones too)
    K-contiguous, strides (…, 1, K), and grouped and int4 ones row-major;
    to_k_major relays an N-contiguous tree (as the JAX bridge receives one)
    in place to the same layout and leaves every other leaf alone; every
    route gives the same output on either layout."""
    from flux_generator_tpu_torch.io.params import take_layer
    from flux_generator_tpu_torch.ops.quant import is_k_major, quantize_tree, to_k_major

    g = torch.Generator().manual_seed(0)
    tree = {"stack": {"kernel": torch.randn(3, 512, 64, generator=g)},
            "grouped": {"kernel": torch.randn(512, 64, generator=g)},
            "int4": {"kernel": torch.randn(512, 64, generator=g)},
            "bf16": {"kernel": torch.randn(512, 64, generator=g)}}
    q = quantize_tree({"stack": tree["stack"]})
    q["grouped"] = quantize_tree(tree["grouped"], group_size=128)
    q["int4"] = quantize_tree(tree["int4"], bits=4, pack=True)
    q["bf16"] = tree["bf16"]
    assert q["stack"]["kernel_q"].stride() == (512 * 64, 1, 512)
    assert is_k_major(take_layer(q["stack"], 1)["kernel_q"])
    assert q["grouped"]["kernel_q"].is_contiguous() and q["int4"]["kernel_q4"].is_contiguous()
    values = q["stack"]["kernel_q"].clone()
    q["stack"]["kernel_q"] = values.contiguous()  # N-contiguous, as a bridged tree arrives
    x = torch.randn(20, 512, generator=g)
    before = {r: tl.dense(take_layer(q["stack"], 1), x, w8a8=r) for r in ROUTES}
    kept = {key: q[key][name] for key, name in (("grouped", "kernel_q"), ("int4", "kernel_q4"),
                                                ("bf16", "kernel"))}
    assert to_k_major(q) is q
    assert q["stack"]["kernel_q"].stride() == (512 * 64, 1, 512)
    assert torch.equal(q["stack"]["kernel_q"], values)
    assert all(q[key][name] is kept[key] for key, name in (("grouped", "kernel_q"), ("int4", "kernel_q4"),
                                                           ("bf16", "kernel")))
    relaid = q["stack"]["kernel_q"]
    assert to_k_major(q)["stack"]["kernel_q"] is relaid  # already K-contiguous: kept
    for r in ROUTES:
        assert torch.equal(tl.dense(take_layer(q["stack"], 1), x, w8a8=r), before[r])


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = (tw.launches, tw.quantize_launches)
    x, wq, ws = _mk(11, 32, 512, 64)
    xt = torch.from_numpy(x)
    assert torch.equal(tw.w8a8_matmul(xt, torch.from_numpy(wq), torch.from_numpy(ws)),
                       tw.w8a8_matmul_reference(xt, torch.from_numpy(wq), torch.from_numpy(ws)))
    assert torch.equal(tw.quantize_rows(xt)[0], tw.quantize_rows_reference(xt)[0])
    assert (tw.launches, tw.quantize_launches) == before


@pytest.mark.parametrize("bad", ["f32", "k_100", "grouped", "f64_scales", "int16_weight", "n_contiguous",
                                 "misaligned_weight", "scale_length", "k_mismatch", "weight_3d",
                                 "strided_scales"])
def test_kernel_argument_checks_raise(bad):
    """The wrapper's checks run before any build, so they raise here too. The
    weight is K-contiguous, as ops.quant stores it, unless `bad` says."""
    x = torch.zeros(32, 512, dtype=torch.bfloat16)
    wq = torch.zeros(64, 512, dtype=torch.int8).t()
    ws = torch.ones(64)
    if bad == "f32":
        x = x.float()
    elif bad == "k_100":
        x, wq = torch.zeros(32, 100, dtype=torch.bfloat16), torch.zeros(64, 100, dtype=torch.int8).t()
    elif bad == "grouped":
        ws = torch.ones(4, 64)
    elif bad == "f64_scales":
        ws = ws.double()
    elif bad == "int16_weight":
        wq = wq.to(torch.int16)
    elif bad == "n_contiguous":
        wq = wq.contiguous()
    elif bad == "misaligned_weight":  # K-contiguous, but starting one byte into its buffer (TMA takes 16)
        wq = torch.zeros(64 * 512 + 16, dtype=torch.int8)[1:1 + 64 * 512].view(64, 512).t()
    elif bad == "scale_length":
        ws = torch.ones(63)
    elif bad == "k_mismatch":
        wq = torch.zeros(64, 384, dtype=torch.int8).t()
    elif bad == "weight_3d":
        wq = torch.zeros(2, 64, 512, dtype=torch.int8).transpose(1, 2)
    elif bad == "strided_scales":
        ws = torch.ones(128)[::2]
    with pytest.raises(ValueError):
        tw._w8a8_matmul_cuda(x, wq, ws)


# ragged shapes on the card: N 700 and 130 store from registers in 128-wide
# tiles; 1100 rows and N 2300 (registers, K blocks of 128) or 2296 (TMA, clipped;
# K blocks of 256) in 192-wide ones
RAGGED = [(77, 1536, 700), (16, 384, 130), (1100, 384, 2300), (1100, 768, 2296)]


# G's persistent grid (blocks, tile width) on an H100 for each of G_SHAPES and
# RAGGED, counted by hand: one block an SM (its shared memory takes one an SM)
# unless the 128-row tiles are fewer
H100_GRIDS = [(132, 128), (132, 128), (132, 192), (128, 192), (132, 192), (128, 192), (96, 192), (48, 128),
              (128, 192), (48, 128), (48, 128), (8, 128), (6, 128), (2, 128), (108, 192), (108, 192)]


@pytest.mark.parametrize("sms,m,n,blocks,bn", [
    *((H100_SMS, m, n, blocks, bn) for (m, k, n), (blocks, bn) in zip(G_SHAPES + RAGGED, H100_GRIDS)),
    (114, 1280, 21504, 114, 192),  # linear1 ties at 114 SMs (⌈1120 / 114⌉ · 192 = ⌈1680 / 114⌉ · 128): 192
    (114, 256, 9216, 96, 192),  # text qkv: 2 × 48 tiles, fewer than the SMs
    (1, 1280, 21504, 1, 192),  # one SM: one block walks every tile, the wider ones
    (1, 1024, 3072, 1, 192)])
def test_grid_is_one_block_an_sm_and_no_more_than_the_tiles(sms, m, n, blocks, bn):
    """G's persistent grid and tile width on a card of `sms` SMs, pinned."""
    assert tw.tile_n(m, n, sms) == bn
    assert tw.grid(m, n, sms) == blocks


def test_tile_width_fills_the_blocks_most_evenly():
    """On an H100 (132 SMs) the 192-wide tiles go where they leave the
    busiest block fewer columns (⌈tiles / 132⌉ · width; ties to 192), the
    128-wide ones elsewhere, as measured in turns on the card."""
    got = [tw.tile_n(m, n, H100_SMS) for m, k, n in G_SHAPES]
    assert got == [128, 128, 192, 192, 192, 192, 192, 128, 192, 128, 128, 128]
    assert [tw.tile_n(m, n, H100_SMS) for m, k, n in RAGGED] == [128, 128, 192, 192]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", G_SHAPES + RAGGED)
def test_cuda_w8a8_matmul_matches_plain_version(cuda, m, k, n):
    """Kernel G, on the K-contiguous weights ops.quant stores, against its
    plain version on the same bf16 inputs: the same quantization and exact
    integer dots, the f32 fold rounded one operation at a time in block
    order in both, the same output products: equal bit for bit, at every
    shape of a Flux 512² request and at ragged M and N in both tile widths
    and both stores (RAGGED). Two runs are equal, and each call counts one
    launch."""
    x, wq, ws = _mk(12, m, k, n)
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    w = torch.from_numpy(wq).to(cuda).t().contiguous().t()
    s = torch.from_numpy(ws).to(cuda)
    ref = tw.w8a8_matmul_reference(xt, w, s)
    before = tw.launches
    out = tw.w8a8_matmul(xt, w, s)
    assert tw.launches == before + 1
    again = tw.w8a8_matmul(xt, w, s)
    torch.cuda.synchronize()
    assert tw.launches == before + 2
    assert torch.equal(out, ref)
    assert torch.equal(out, again)


# H's activation shapes in a Flux-schnell 512² "rows" request (M, K)
H_SHAPES = [(1280, 3072), (1280, 15360), (1024, 3072), (1024, 12288), (256, 3072), (256, 12288), (256, 4096)]
# beyond them: one row, K % 8 != 0 (the scalar kernel), rows too long for
# registers (two sweeps), and short rows that share a block
H_EDGES = [(1, 3072), (17, 100), (3, 70000), (2, 131072), (5, 520)]


@pytest.mark.parametrize("shape,want", [
    ((1280, 3072), dict(route="registers", chunks=4, tpr=96, rows=2, blocks=640)),
    ((1280, 15360), dict(route="registers", chunks=8, tpr=256, rows=1, blocks=1280)),
    ((1024, 3072), dict(route="registers", chunks=4, tpr=96, rows=2, blocks=512)),
    ((1024, 12288), dict(route="registers", chunks=8, tpr=192, rows=1, blocks=1024)),
    ((256, 3072), dict(route="registers", chunks=1, tpr=384, rows=1, blocks=256)),
    ((256, 12288), dict(route="registers", chunks=4, tpr=384, rows=1, blocks=256)),
    ((256, 4096), dict(route="registers", chunks=1, tpr=512, rows=1, blocks=256)),
    ((1, 3072), dict(route="registers", chunks=1, tpr=384, rows=1, blocks=1)),
    ((17, 100), dict(route="scalar", chunks=0, tpr=32, rows=8, blocks=3)),
    ((3, 70000), dict(route="sweep", chunks=8, tpr=512, rows=1, blocks=3)),
    ((2, 131072), dict(route="sweep", chunks=8, tpr=512, rows=1, blocks=2)),
    ((5, 520), dict(route="registers", chunks=1, tpr=96, rows=2, blocks=3)),
])
def test_quantize_geometry_on_an_h100_is_pinned(shape, want):
    """H's launch on an H100 (132 SMs) at each request shape and past them,
    pinned: with 4 rows an SM or more (M 1024, 1280) a thread takes the most
    chunks that waste at most 1/8 of a row's threads, so the most rows are
    in flight; with fewer (M 256) the fewest chunks that keep a row within
    512 threads."""
    assert tw.quantize_geometry(*shape, H100_SMS)._asdict() == want


def test_quantize_geometry_is_computed_once_a_shape():
    """H runs 920 times a "rows" request on seven shapes: its launch is
    looked up, not rebuilt, after a shape's first call."""
    assert tw.quantize_geometry(1024, 3072, H100_SMS) is tw.quantize_geometry(1024, 3072, H100_SMS)


@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("m,k", H_SHAPES + H_EDGES + [(4096, 64), (600, 4096), (7, 8), (2, 32768), (2, 32776)])
def test_quantize_geometry_covers_every_row_once(sms, m, k):
    """Whatever the card: whole warps a row, at most 512 threads a block,
    every row in a block, and a held row covered by its threads' chunks (or
    the route that sweeps it twice)."""
    geo = tw.quantize_geometry(m, k, sms)
    assert geo.tpr % 32 == 0 and geo.tpr * geo.rows <= tw.H_MAX_THREADS
    assert geo.blocks * geo.rows >= m > (geo.blocks - 1) * geo.rows
    if k % 8:
        assert geo.route == "scalar"
        return
    held = geo.tpr * geo.chunks * 8 >= k
    assert geo.route == ("registers" if k <= tw.H_REG_VALUES else "sweep")
    assert held or geo.route != "registers"
    assert geo.chunks in (1, 2, 4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", H_SHAPES + H_EDGES)
def test_cuda_quantize_rows_matches_plain_version(cuda, m, k):
    """Kernel H against its plain version: bytes and scales equal (the same
    correctly rounded f32 operations), at every shape of a "rows" request
    and on every route (scalar, registers, two sweeps), with one
    outlier a row."""
    x, _, _ = _mk(13, m, k, 1)
    x[:, 3 % k] = 37.0
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    before = tw.quantize_launches
    q, s = tw.quantize_rows(xt)
    torch.cuda.synchronize()
    assert tw.quantize_launches == before + 1
    rq, rs = tw.quantize_rows_reference(xt)
    assert torch.equal(q, rq) and torch.equal(s, rs)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1280, 3072), (256, 12288), (5, 520)])
def test_cuda_quantize_rows_every_geometry_is_bit_equal(cuda, m, k):
    """The geometries H did not choose (every other chunk count, as
    scripts/prof_quantize_rows.py times them) give the same bytes and
    scales."""
    from flux_generator_tpu_torch.scripts.prof_quantize_rows import settings

    x, _, _ = _mk(15, m, k, 1)
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    rq, rs = tw.quantize_rows_reference(xt)
    for name, geo in settings(m, k, torch.cuda.get_device_properties(cuda).multi_processor_count).items():
        q, s = tw._launch_h(xt, geo)
        torch.cuda.synchronize()
        assert torch.equal(q, rq) and torch.equal(s, rs), name


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3072, 18432), (1024, 3072, 64), (5, 100, 7), (64, 64, 256),
                                   (1, 64, 64)])
def test_cuda_int8_dot_is_exact(cuda, m, k, n):
    """The padded torch._int_mm product on the card, on K-contiguous
    weights, at the modulations' M = 1, the final linear's N = 64, shapes
    that need K and N padding, and K 64; an N-contiguous weight raises."""
    rng = np.random.default_rng(14)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    w = torch.from_numpy(b).to(cuda)
    got = tl.int8_dot(torch.from_numpy(a).to(cuda), w.t().contiguous().t())
    np.testing.assert_array_equal(got.cpu().numpy(), a.astype(np.int64) @ b.astype(np.int64))
    if k > 1 and n > 1:
        with pytest.raises(ValueError, match="K-contiguous"):
            tl.int8_dot(torch.from_numpy(a).to(cuda), w)
