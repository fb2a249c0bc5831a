"""Flash attention with fused RoPE: the port's plain version against the JAX
Pallas kernel (interpret mode on CPU), and the CUDA kernel against the
plain version on a card.

jax is imported inside the tests that use it, so the `cuda` case runs on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py`."""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
from flux_generator_tpu_torch.ops.rope import multi_axis_rope, rope_cos_sin


def _inputs(seed, b, l, h, d, rope):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    cos = sin = None
    if rope:
        # per-batch tables: each batch row its own positions
        pos = np.stack([np.arange(l) + 37 * i for i in range(b)]).astype(np.float32)
        c, s = rope_cos_sin(torch.from_numpy(pos), d)
        cos, sin = c.numpy(), s.numpy()
    return q, k, v, cos, sin


CASES = {
    "d128_rope": (1, 256, 2, 128, True),
    "d64_norope": (1, 256, 2, 64, False),
    "l300_padding": (1, 300, 2, 64, True),
    "b2_per_batch_tables": (2, 300, 2, 128, True),
    # ragged lengths at head dim 64: 8 key tiles, the last ragged; one past a tile
    "d64_b2_l1000_norope": (2, 1000, 2, 64, False),
    "d64_l129_norope": (1, 129, 2, 64, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_kernel(case):
    """atol 3e-5, the tolerance of tests/test_pallas_flash.py: f32 on both
    sides, differing only in summation order."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    q, k, v, cos, sin = _inputs(1, *CASES[case])
    jargs = [jnp.asarray(a) if a is not None else None for a in (q, k, v, cos, sin)]
    want = jax_flash(*jargs[:3], cos=jargs[3], sin=jargs[4], interpret=True)
    targs = [torch.from_numpy(a) if a is not None else None for a in (q, k, v, cos, sin)]
    got, lse = fa.flash_attention_reference(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    assert lse.shape == (q.shape[0] * q.shape[2], q.shape[1])


# (B, L, H) at head dim 64 and key ranges, each a part of every tile, as the
# three-warpgroup kernel splits its last round over keys: parts of whole
# 128-key tiles, a ragged last key tile, a part of one key, uneven parts
SPLITS = {
    "l256_two_parts": ((1, 256, 3), ((0, 128), (128, 256))),
    "l300_ragged_last_tile": ((1, 300, 2), ((0, 128), (128, 256), (256, 300))),
    "l129_part_of_one_key": ((1, 129, 2), ((0, 128), (128, 129))),
    "b2_l1000_uneven": ((2, 1000, 2), ((0, 384), (384, 896), (896, 1000))),
    "l640_four_parts": ((1, 640, 2), ((0, 128), (128, 384), (384, 512), (512, 640))),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_split_plain_version_matches_jax_kernel(case):
    """The plain version of the kernel's split over keys (each part's
    unnormalised O, row max and row sum, then their merge in part order)
    against the JAX kernel in interpret mode: atol 3e-5 as
    test_plain_version_matches_jax_kernel (f32 on both sides, differing in
    summation order and in the maxima the parts' exponentials take), lse
    within 1e-5 of the plain version's. The control: the merge of the parts
    without any one of them must miss the out bound."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    (b, l, h), keys = SPLITS[case]
    q, k, v, _, _ = _inputs(14, b, l, h, 64, False)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    parts = [fa.attention_part_reference(tq, tk, tv, r) for r in keys]
    out, lse = fa.merge_parts_reference(parts)
    np.testing.assert_allclose(out.numpy(), want, atol=3e-5)
    _, ref_lse = fa.flash_attention_reference(tq, tk, tv)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)
    for drop in range(len(parts)):
        dropped, _ = fa.merge_parts_reference(parts[:drop] + parts[drop + 1:])
        assert np.abs(dropped.numpy() - want).max() > 3e-5


@pytest.mark.parametrize("rope", [True, False])
def test_lse_is_logsumexp_of_logits(rope):
    b, l, h, d = 2, 40, 3, 64
    q, k, v, cos, sin = (torch.from_numpy(a) if a is not None else None
                         for a in _inputs(2, b, l, h, d, rope))
    _, lse = fa.flash_attention_reference(q, k, v, cos, sin)
    if rope:
        q, k = fa._rope_f32(q, cos, sin), fa._rope_f32(k, cos, sin)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).reshape(b * h, l).numpy(),
                               atol=1e-5, rtol=1e-6)


def test_plain_version_matches_rope_then_attention():
    """The fused rotation equals ops.rope.apply_rope followed by plain
    attention — the JAX package's non-kernel path in models/flux/model.py."""
    from flux_generator_tpu_torch.ops.attention import dot_product_attention
    from flux_generator_tpu_torch.ops.rope import apply_rope

    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 30, (1, 50, 3)).astype(np.int32))
    cos, sin = multi_axis_rope(ids, [16, 56, 56])
    q, k, v, _, _ = (torch.from_numpy(a) if a is not None else None
                     for a in _inputs(4, 1, 50, 2, 128, False))
    got = fa.flash_attention(q, k, v, cos=cos, sin=sin)
    want = dot_product_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = fa.launches
    q, k, v, cos, sin = (torch.from_numpy(a) for a in _inputs(5, 1, 20, 2, 64, True))
    out, lse = fa.flash_attention(q, k, v, cos, sin, return_lse=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, cos, sin)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert fa.launches == before


@pytest.mark.parametrize("bad", ["f32", "head_dim_16", "non_contiguous", "table_shape", "one_table"])
def test_kernel_argument_checks_raise(bad):
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    k, v = q.clone(), q.clone()
    cos = sin = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    if bad == "f32":
        q, k, v = q.float(), k.float(), v.float()
    elif bad == "head_dim_16":
        q = k = v = torch.zeros(1, 8, 16, 16, dtype=torch.bfloat16)
        cos = sin = torch.zeros(1, 8, 8, dtype=torch.bfloat16)
    elif bad == "non_contiguous":
        q = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    elif bad == "table_shape":
        cos = sin = torch.zeros(1, 8, 32, dtype=torch.bfloat16)
    elif bad == "one_table":
        sin = None
    with pytest.raises(ValueError):
        fa._check_cuda_args(q, k, v, cos, sin)


def test_rope_pre_pass_plain_version_is_rope_f32_rounded():
    """The bf16 mode's pre-pass rotates q and k as the fused plain version
    does: `_rope_f32` with the tables rounded to bf16, then rounded to bf16."""
    q, k, _, cos, sin = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(7, 2, 33, 3, 64, True))
    qr, kr = fa.rope_rotate_reference(q, k, cos.float(), sin.float())
    assert qr.dtype == kr.dtype == torch.bfloat16
    assert torch.equal(qr, fa._rope_f32(q, cos, sin).to(torch.bfloat16))
    assert torch.equal(kr, fa._rope_f32(k, cos, sin).to(torch.bfloat16))
    before = fa.rope_launches
    assert all(torch.equal(a, b) for a, b in zip(fa.rope_rotate(q, k, cos, sin), (qr, kr)))
    assert fa.rope_launches == before


@pytest.mark.parametrize("rope", [True, False])
def test_bf16_route_matches_jax_prerotated_path(rope):
    """The bf16 mode's route (pre-rotate, then attention without tables)
    against the JAX wrapper's own pre-rotated path, forced as its tests force
    it: a one-shot limit of 128 at L 300 pads to 384 and pre-rotates q and k
    in HBM. f32 on both sides, atol 3e-5 as test_pallas_flash.py."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
    from flux_generator_tpu.runtime.config import set_flash_attention

    q, k, v, cos, sin = _inputs(8, 1, 300, 2, 64, rope)
    jargs = [jnp.asarray(a) if a is not None else None for a in (q, k, v, cos, sin)]
    set_flash_attention(one_shot_max=128, blk_q=128, blk_k=128)
    try:
        want = jax_flash(*jargs[:3], cos=jargs[3], sin=jargs[4], interpret=True)
    finally:
        set_flash_attention()
    targs = [torch.from_numpy(a) if a is not None else None for a in (q, k, v, cos, sin)]
    got, lse = fa.bf16_forward(*targs, scale=64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    _, ref_lse = fa.flash_attention_reference(*targs)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)


@pytest.mark.parametrize("bad", ["base_address", "row_stride", "table_base_address"])
def test_tma_alignment_checks_raise(bad):
    """TMA takes 16-byte aligned base addresses and strides (the pre-pass's
    table loads 8-byte aligned ones): the wrapper raises, there is no
    fallback."""
    flat = torch.zeros(1 + 8 * 2 * 128, dtype=torch.bfloat16)
    q = flat[:-1].view(1, 8, 2, 128)
    fa._check_aligned(q)
    if bad == "base_address":
        with pytest.raises(ValueError, match="aligned"):
            fa._check_aligned(flat[1:].view(1, 8, 2, 128))
    elif bad == "row_stride":
        wide = torch.zeros(1, 8, 2, 132, dtype=torch.bfloat16)[..., :4]  # rows of 264 bytes
        with pytest.raises(ValueError, match="strides"):
            fa._check_aligned(wide)
    else:
        table = torch.zeros(1 + 8 * 64, dtype=torch.bfloat16)[1:].view(1, 8, 64)
        with pytest.raises(ValueError, match="aligned"):
            fa._check_aligned(table, align=8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d,rope", [(1, 1280, 24, 128, True), (1, 1000, 4, 128, True),
                                          (2, 300, 3, 64, False), (1, 77, 2, 128, False),
                                          (2, 65, 3, 64, True), (3, 1, 2, 128, True),
                                          (1, 512, 3, 128, False), (2, 384, 2, 128, True)])
def test_cuda_kernel_matches_plain_version(b, l, h, d, rope):
    """bf16 kernel (after the RoPE pre-pass when tables are given) against the
    plain version run in f32 on the same bf16 inputs; atol 2e-2 because P is
    rounded to bf16 before P·V and O is stored in bf16. L 512 and 384 are
    whole 128-row tiles; B 2 with RoPE has a table of its own a batch row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q, k, v, cos, sin = (torch.from_numpy(a).to(dev, torch.bfloat16) if a is not None else None
                         for a in _inputs(6, b, l, h, d, rope))
    before = (fa.launches, fa.rope_launches)
    out, lse = fa.flash_attention(q, k, v, cos, sin, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.launches, fa.rope_launches) == (before[0] + 1, before[1] + int(rope))
    f32 = (lambda t: None if t is None else t.float())
    ref, ref_lse = fa.flash_attention_reference(f32(q), f32(k), f32(v), f32(cos), f32(sin))
    assert (out.float() - ref).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_cuda_rope_pre_pass_matches_plain_version_bit_for_bit():
    """The pre-pass rounds each product and sum as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q, k, _, cos, sin = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in _inputs(9, 2, 300, 3, 128, True))
    got = fa.rope_rotate(q, k, cos, sin)
    want = fa.rope_rotate_reference(q, k, cos, sin)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# (B·H, L) of the persistent launch: Flux's head-dim-128 shapes (L 1280 and
# 16640 with 24 heads, the tensor-parallel shards' 12 and 6, the ring's folds
# at L 8320 and 4160, training's L 1536, L 1000), ragged lengths, SDXL
# batch 4's L 256 at head dim 64, B·H past 65535 and one tile
SCHEDULE_SHAPES = [(24, 1280), (24, 16640), (12, 1280), (6, 1280), (24, 8320), (24, 4160), (24, 1536),
                   (24, 1000), (48, 1031), (80, 256), (65600, 48), (1, 1)]


SM90_SOURCE = pathlib.Path(fa.__file__).parents[2] / "csrc" / "flash_attention_sm90.cu"


def _sm90_schedule(bh: int, length: int, sms: int) -> list:
    """The persistent kernel's static schedule as its source writes it (held
    there by test_sm90_kernel_source_takes_the_static_schedule): a grid of
    min(SMs, tiles) CTAs, CTA c taking tiles c, c + G, c + 2G, …, tile i
    being row block i % ⌈L/128⌉ of head i // ⌈L/128⌉ → for each CTA its
    (head, row block) tiles in order."""
    rb = -(-length // 128)
    tiles = bh * rb
    grid = min(sms, tiles)
    return [[divmod(i, rb) for i in range(c, tiles, grid)] for c in range(grid)]


def test_sm90_kernel_source_takes_the_static_schedule():
    """The kernel's source holds the schedule that _sm90_schedule mirrors:
    the launch clamps the SM count it is given to the tile count, the
    producer and the consumers walk the same tiles with the grid's stride,
    and a tile's (head, row block) comes from its index alone."""
    src = SM90_SOURCE.read_text()
    assert "const int grid = static_cast<int>(ctas < tiles ? ctas : tiles);" in src
    assert src.count("for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {") == 2
    assert src.count("tile_coords(tile, row_blocks, H, bh, b, h, q0);") == 2
    assert "  bh = tile / row_blocks;\n  q0 = (tile - bh * row_blocks) * BM;\n" in src
    assert "constexpr int BM = 128;" in src


@pytest.mark.parametrize("bh,l", SCHEDULE_SHAPES)
def test_sm90_schedule_covers_each_tile_once(bh, l):
    """The persistent kernel's static schedule on an H100's 132 SMs: every
    (head, row block) tile exactly once, one CTA a tile up to one an SM,
    the CTAs' shares within one tile of each other, each CTA's tiles in
    order, and the tiles of one round side by side (a head's row blocks
    together, so they share its K and V in L2)."""
    rb = -(-l // 128)
    sched = _sm90_schedule(bh, l, 132)
    assert len(sched) == min(bh * rb, 132)
    flat = [t for cta in sched for t in cta]
    assert sorted(flat) == [(x, r) for x in range(bh) for r in range(rb)]
    assert max(map(len, sched)) - min(map(len, sched)) <= 1
    for cta in sched:
        assert cta == sorted(cta)
    first_round = [cta[0] for cta in sched]
    assert [x * rb + r for x, r in first_round] == list(range(len(sched)))


# the head-dim-64 kernel's shapes: the SD and SDXL self-attention of a 512²
# request (B, L, H)
SD_SHAPES = [(b, l, h) for _, b, l, h, _ in chip_smoke.SD_ATTN_SHAPES]
# (B, L, H) → the consumer warpgroups `d64_geometry` picks on 132 SMs: the
# SD and SDXL shapes of a 512² request, SD 2.1's first level at 640² and
# 1024² (with CFG, and at 1024² without), two of whole rounds of 128-row
# tiles, B·H 2, ragged lengths, one key, and B·H past 65535
D64_GEOMETRIES = {
    **{(b, l, h): w for (b, l, h), w in zip(SD_SHAPES, (3, 3, 2, 2, 2, 2, 2))},
    (2, 6400, 5): 3, (2, 16384, 5): 3, (1, 16384, 5): 3,
    (1, 4096, 33): 3, (1, 1024, 33): 2, (1, 4096, 2): 3,
    (2, 300, 3): 2, (2, 1000, 10): 3, (1, 4160, 5): 3, (1, 129, 2): 2, (4, 1, 2): 2,
    (1, 48, 65600): 2,
}


@pytest.mark.parametrize("b,l,h", list(D64_GEOMETRIES))
def test_d64_geometry_at_each_shape(b, l, h):
    """The host's choice for the head-dim-64 launch on an H100's 132 SMs,
    the faster geometry as measured at each shape: three warpgroups (192
    rows) where a head has many key tiles (SD 2.1 at L 1024 to 16384, and,
    its last round split over keys, B·H 2 at L 4096: 44 tiles over 128
    CTAs against one round of 64 tiles of two), two where a tile's own cost
    outweighs its few key tiles or the rounds of two are whole (SDXL batch
    1 and 4 at L 1024, a tie at batch 4 kept at two; L 1024 with 33 heads;
    B·H 65600 of one key tile). Asked again, the answer comes from the
    cache."""
    want = D64_GEOMETRIES[(b, l, h)]
    assert fa.d64_geometry(b * h, l, 132) == want
    hits = fa.d64_geometry.cache_info().hits
    assert fa.d64_geometry(b * h, l, 132) == want
    assert fa.d64_geometry.cache_info().hits == hits + 1


def test_d64_geometry_follows_the_rounds():
    """On 132 SMs: SD 2.1 at L 1024 (B·H 20) takes three warpgroups, 120
    tiles in one round against 160 of two in two; on a card of 160 SMs,
    where 160 tiles of two fit one round, two; a head of few key tiles
    stays at two however many tiles there are (L 256 at B·H 400). Three
    warpgroups split a part-empty last round over keys on every SM (SD 2.1
    at 1024² without CFG: 430 tiles, the fourth round's 34 over 132 CTAs)
    and run a round that no split can shorten whole (L 1024, B·H 20: 8 key
    tiles a tile, 960 over 132 CTAs still 8 each)."""
    assert fa.d64_geometry(20, 1024, 132) == 3
    assert fa.d64_geometry(20, 1024, 160) == 2
    assert fa.d64_geometry(400, 256, 132) == 2
    assert fa.d64_split(5, 16384, 132)[:2] == (132, 132)
    assert fa.d64_split(20, 1024, 132)[:2] == (120, 0)


def _sd_check(q, k, v, out, lse, drop: int):
    """out within rel-L2 1e-2 and atol 2e-2 of the plain version run in f32
    on the same bf16 inputs, lse within 2e-2; the plain version with the
    last `drop` keys dropped must fail the rel-L2 bound."""
    ref, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 2e-2
    assert (out.float() - ref).norm() / ref.norm() <= 1e-2
    dropped, _ = fa.flash_attention_reference(q.float(), k[:, :-drop].float(), v[:, :-drop].float())
    assert (dropped - ref).norm() / ref.norm() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h", SD_SHAPES)
def test_cuda_kernel_at_sd_shapes(b, l, h):
    """bf16 kernel at head dim 64 without RoPE, as the UNet calls it, at every
    row of chip_smoke.SD_ATTN_SHAPES (in `d64_geometry`'s geometry),
    against the plain version run in f32 on the same bf16 inputs: the atol
    2e-2 of test_cuda_kernel_matches_plain_version, and out within rel-L2
    1e-2. The output averages over many keys (its entries are about 0.02 at
    L 4096), so only the rel-L2 bound catches an output some 10% wrong; the
    plain version with the last 64 keys dropped must fail it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in _inputs(10, b, l, h, 64, False)[:3])
    before = (fa.launches, fa.rope_launches)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert (fa.launches, fa.rope_launches) == (before[0] + 1, before[1])
    _sd_check(q, k, v, out, lse, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h", [(2, 300, 3), (2, 1000, 10), (1, 4160, 5)])
def test_cuda_kernel_at_every_geometry(b, l, h):
    """The head-dim-64 route at ragged lengths (3, 8 and 33 key tiles, the
    last ragged), through the route (in `d64_geometry`'s warpgroups) and
    at both geometries the launch can take (2 or 3 consumer warpgroups),
    each against the plain version as test_cuda_kernel_at_sd_shapes, with
    32 keys dropped as the control."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in _inputs(11, b, l, h, 64, False)[:3])
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    _sd_check(q, k, v, out, lse, 32)
    for w in fa.WARPGROUPS_D64:
        before = fa.launches
        out, lse = fa._sm90_launch(q, k, v, 64 ** -0.5, warpgroups=w)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        _sd_check(q, k, v, out, lse, 32)


@pytest.mark.cuda
def test_cuda_kernel_past_the_grid_cap():
    """B·H = 65600 heads of 48 keys at head dim 64: past the 65535 of a
    grid's second dimension, which neither kernel's grid is bound by (the
    persistent two-warpgroup kernel, `d64_geometry`'s pick, launches one
    CTA an SM; the three-warpgroup kernel continues B·H in its grid's third
    dimension). Both geometries held as test_cuda_kernel_at_sd_shapes, with
    the last 16 keys dropped as the control."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn((1, 48, 65600, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    _sd_check(q, k, v, out, lse, 16)
    out, lse = fa._sm90_launch(q, k, v, 64 ** -0.5, warpgroups=3)
    torch.cuda.synchronize()
    _sd_check(q, k, v, out, lse, 16)


# (B, L, H) at head dim 64 where the three-warpgroup kernel splits its last
# round over keys on an H100's 132 SMs: SD 2.1 at 1024² without CFG (430
# tiles: 3 whole rounds, 34 tiles in 4-5 parts), the ragged L 4160 (110
# tiles in one round, cut over 130 CTAs), L 4096 with 33 heads (66 tiles of
# the sixth round in 2 parts)
SPLIT_SHAPES = [(1, 16384, 5), (1, 4160, 5), (1, 4096, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h", SPLIT_SHAPES)
def test_cuda_kernel_split_tail(b, l, h):
    """The three-warpgroup kernel where it splits its last round over keys,
    through the route: one launch, `d64_merges` (the kernel's own count)
    up by three a split tile of `d64_tail`'s plan, out within rel-L2 1e-2
    and atol 2e-2 of the plain version run in f32 on the same bf16 inputs,
    lse within 2e-2, the plain version with the last 64 keys dropped failing
    the rel-L2 bound; outputs laid over freed NaN memory (a row the merge
    skipped would stay NaN); a second call equal bit for bit (the parts fold
    in part order, whichever finishes last); and the same launch in whole
    tiles within the same bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fa.d64_geometry(b * h, l, sms) == 3
    parts = fa.d64_tail(b * h, l, *fa.d64_split(b * h, l, sms)[:2])
    split = sum(p > 1 for p in parts)
    assert split > 0
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn((b, l, h, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    nan_out = torch.full_like(q, float("nan"))
    nan_lse = torch.full((b * h, l), float("nan"), device=dev)
    del nan_out, nan_lse
    before, merges = fa.launches, fa.d64_merges(dev)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert fa.d64_merges(dev) - merges == 3 * split
    assert not out.isnan().any() and not lse.isnan().any()
    ref, ref_lse = _plain_in_chunks(q, k, v)
    dropped, _ = _plain_in_chunks(q, k, v, drop=64)
    again, again_lse = fa.flash_attention(q, k, v, return_lse=True)
    whole, whole_lse = fa._sm90_launch(q, k, v, 64 ** -0.5, warpgroups=3, split=False)
    torch.cuda.synchronize()
    assert torch.equal(again, out) and torch.equal(again_lse, lse)
    for o, s in ((out, lse), (whole, whole_lse)):
        assert (o.float() - ref).abs().max().item() < 2e-2
        assert (s - ref_lse).abs().max().item() < 2e-2
        assert (o.float() - ref).norm() / ref.norm() <= 1e-2
    assert (dropped - ref).norm() / ref.norm() > 1e-2


def _plain_in_chunks(q, k, v, drop: int = 0):
    """The plain version in f32 on the same bf16 inputs, a few heads at a
    time (at most 2^29 logits a chunk), with the last `drop` keys dropped →
    (out, lse)."""
    b, l, h, _ = q.shape
    n = l - drop
    chunk = max(1, min(h, (1 << 29) // (b * l * n)))
    outs, lses = [], []
    for i in range(0, h, chunk):
        o, s = fa.flash_attention_reference(q[:, :, i:i + chunk].float(), k[:, :n, i:i + chunk].float(),
                                            v[:, :n, i:i + chunk].float())
        outs.append(o)
        lses.append(s.reshape(b, -1, l))
    return torch.cat(outs, 2), torch.cat(lses, 1).reshape(b * h, l)


# (B, L, H) at head dim 128: Flux's L 1280 (512²) and 16640 (2048²) with 24
# heads, the tensor-parallel shards (12, 6 heads), the ring's folds (L 8320,
# 4160), training's L 1536, L 1000 and L 1031 (ragged, several tiles a CTA),
# and B·H past 65535
FLUX_SHAPES = [(1, 1280, 24), (1, 16640, 24), (1, 1280, 12), (1, 1280, 6), (1, 8320, 24), (1, 4160, 24),
               (1, 1536, 24), (1, 1000, 24), (2, 1031, 24), (1, 48, 65600)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h", FLUX_SHAPES)
def test_cuda_persistent_kernel_at_flux_shapes(b, l, h):
    """The persistent bf16 kernel at head dim 128 without RoPE, as the flow
    calls it after the pre-pass, against the plain version run in f32 on
    the same bf16 inputs: out within rel-L2 1e-2 and atol 2e-2, lse within
    2e-2; the plain version with the last 64 keys (16 at L 48) dropped must
    fail the rel-L2 bound. Just before the call, NaN tensors the size of out
    and lse are made and freed, so the wrapper's outputs take their memory:
    a row or an lse entry the kernel skipped would stay NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn((b, l, h, 128), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    nan_out = torch.full_like(q, float("nan"))
    nan_lse = torch.full((b * h, l), float("nan"), device=dev)
    del nan_out, nan_lse
    before = (fa.launches, fa.rope_launches)
    out, lse = fa.flash_attention_sm90(q, k, v)
    torch.cuda.synchronize()
    assert (fa.launches, fa.rope_launches) == (before[0] + 1, before[1])
    assert not out.isnan().any() and not lse.isnan().any()
    ref, ref_lse = _plain_in_chunks(q, k, v)
    assert (out.float() - ref).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 2e-2
    assert (out.float() - ref).norm() / ref.norm() <= 1e-2
    dropped, _ = _plain_in_chunks(q, k, v, drop=16 if l < 128 else 64)
    assert (dropped - ref).norm() / ref.norm() > 1e-2
