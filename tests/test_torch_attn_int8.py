"""The int8 tiers of flash attention ("qk": int8 Q·Kᵀ; "full": also int8
P·V): the port's plain version against the JAX Pallas kernel (interpret
mode on CPU) under `set_attn_int8`, the one-shot length guard, the tiers'
straight-through gradient against jax.grad, and the CUDA kernel against the plain version on a card; and
`flash_attention_streamed`, the JAX streamed path whose tiers run at any
length ("full" quantized per group of blk_k keys), against
`_flash_attention_jit` on its streamed path, and its kernel mode on a card;
and the tiers' two steps on the card: the quantize pre-pass (its plain
version against the JAX package's `_quant_rows` / `_quant_cols`, V's
key-permuted transposed layout by hand, the kernels bit for bit against the
plain version) and the int8 attention kernel (its plain version run from the
pre-pass's outputs equal to the tiers' references; the kernel at tile and
slab edges).

jax is imported inside the tests that use it, so the `cuda` cases run on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_attn_int8.py`."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
from flux_generator_tpu_torch.ops.rope import rope_cos_sin

TIERS = ["qk", "full"]


def _inputs(seed, b, l, h, d, rope):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    cos = sin = None
    if rope:
        pos = np.stack([np.arange(l) + 37 * i for i in range(b)]).astype(np.float32)
        c, s = rope_cos_sin(torch.from_numpy(pos), d)
        cos, sin = c.numpy(), s.numpy()
    return q, k, v, cos, sin


def _torch(arrays, device="cpu", dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(device, dtype) for a in arrays]


def _controls(tier, args):
    """Functions a tier must not be, (out, lse) each: the bf16 function and,
    for "full", the "qk" tier and the JAX streamed kernel's "full" tier."""
    out = {"bf16": fa.flash_attention_reference(*args)}
    if tier == "full":
        out["qk"] = fa.flash_attention_reference(*args, int8="qk")
        out["streamed"] = fa.streamed_full_reference(*args)
    return out


CASES = {
    "d128_rope": (1, 256, 2, 128, True),
    "d64_norope": (1, 256, 2, 64, False),
    "l300_padding": (1, 300, 2, 64, True),
    "b2_per_batch_tables": (2, 300, 2, 128, True),
}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_tier_matches_jax_kernel(case, tier):
    """f32 inputs: both sides quantize identically (the same IEEE division
    and rounding) and take exact integer dots; exp and the row sums round in
    another order, which can move one int8 level of p by one step near a
    .5 boundary, ≤ |v|/127/Σp in an output: atol 2e-3."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
    from flux_generator_tpu.runtime.config import set_attn_int8

    q, k, v, cos, sin = _inputs(1, *CASES[case])
    jargs = [None if a is None else jnp.asarray(a) for a in (q, k, v, cos, sin)]
    set_attn_int8(tier)
    try:
        want = np.asarray(jax_flash(*jargs[:3], cos=jargs[3], sin=jargs[4], interpret=True))
    finally:
        set_attn_int8(None)
    args = _torch((q, k, v, cos, sin))
    got = fa.flash_attention(*args, int8=tier)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    # the check can fail: every control lies farther than atol from JAX
    for name, (out, _) in _controls(tier, args).items():
        assert np.abs(out.numpy() - want).max() > 2e-3, name


@pytest.mark.parametrize("case", ["d128_rope", "l300_padding"])
def test_streamed_control_matches_jax_streamed_tier(case):
    """The control `streamed_full_reference` is the JAX streamed kernel's
    "full" tier (its one-shot path turned off, key blocks of 64), within the
    atol of the one-shot comparison and for the same reasons."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import _flash_attention_jit

    q, k, v, cos, sin = _inputs(1, *CASES[case])
    jargs = [None if a is None else jnp.asarray(a) for a in (q, k, v, cos, sin)]
    want = np.asarray(_flash_attention_jit(*jargs, scale=None, interpret=True, blk_k=64, one_shot_max=64,
                                           blk_q=64, int8_mxu="full"))
    got, _ = fa.streamed_full_reference(*_torch((q, k, v, cos, sin)), blk_k=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def _jax_streamed(args, tier, blk_k):
    """The JAX wrapper's jitted core on its streamed path (one-shot limit 64,
    q blocks of 64), interpret mode."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import _flash_attention_jit

    jargs = [None if a is None else jnp.asarray(a) for a in args]
    return np.asarray(_flash_attention_jit(*jargs, scale=None, interpret=True, blk_k=blk_k, one_shot_max=64,
                                           blk_q=64, int8_mxu=tier))


@pytest.mark.parametrize("blk_k", [64, 128, 256])
def test_streamed_full_matches_jax_streamed_path(blk_k):
    """`flash_attention_streamed(..., int8="full", blk_k)` on CPU tensors
    against the JAX streamed kernel at the same key block, L 300 (padded to
    whole blocks, the padded keys masked), RoPE, f32: atol 2e-3, as the
    one-shot comparison and for the same reasons."""
    q, k, v, cos, sin = _inputs(7, 1, 300, 2, 64, True)
    want = _jax_streamed((q, k, v, cos, sin), "full", blk_k)
    before = fa.launches
    got, lse = fa.flash_attention_streamed(*_torch((q, k, v, cos, sin)), int8="full", blk_k=blk_k)
    assert fa.launches == before and lse.shape == (2, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    ref, _ = fa.streamed_full_reference(*_torch((q, k, v, cos, sin)), blk_k=blk_k)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("tier", ["", "qk"])
def test_streamed_path_bf16_and_qk_tiers_match_jax(tier):
    """"" and "qk" do not depend on how the keys are blocked: the streamed
    path's function is the one-shot tier's (f32: atol 1e-5 for "", 2e-3 for
    "qk", whose int8 levels may move by one)."""
    q, k, v, cos, sin = _inputs(8, 1, 300, 2, 64, True)
    want = _jax_streamed((q, k, v, cos, sin), tier, 128)
    got, _ = fa.flash_attention_streamed(*_torch((q, k, v, cos, sin)), int8=tier, blk_k=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 if tier else 1e-5)


def test_streamed_full_groups_hand_check():
    """Two groups of 64 keys on one head by hand: per group m_new, p against
    it, s_p = max p / 127, V per column over the group's rows, then
    acc·α + (dot·s_p)·s_v and l·α + Σp."""
    q, k, v, _, _ = _torch(_inputs(9, 1, 128, 1, 64, False))
    got, lse = fa.flash_attention_streamed(q, k, v, int8="full", blk_k=64)
    qi, sq = fa._quant(q.float(), -1)
    ki, sk = fa._quant(k.float(), -1)
    logits = (qi[0, :, 0] @ ki[0, :, 0].T) * (sq[0, :, 0] * 64 ** -0.5) * sk[0, :, 0].T
    m = torch.full((128, 1), -torch.inf)
    acc, den = torch.zeros(128, 64), torch.zeros(128, 1)
    for g0 in (0, 64):
        s = logits[:, g0:g0 + 64]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        sp = p.amax(-1, keepdim=True).clamp_min(1e-20) / 127
        vg = v[0, g0:g0 + 64, 0]
        sv = vg.abs().amax(0).clamp_min(1e-20) / 127
        dot = (torch.round(p / sp).double() @ torch.clamp(torch.round(vg / sv), -127, 127).double()).float()
        acc = acc * alpha + dot * sp * sv
        den = den * alpha + p.sum(-1, keepdim=True)
        m = m_new
    np.testing.assert_allclose(got[0, :, 0].numpy(), (acc / den).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse[0].numpy(), (m + torch.log(den))[:, 0].numpy(), rtol=1e-6, atol=1e-5)


def test_streamed_tiers_run_past_the_one_shot_length():
    """Unlike `flash_attention`, the streamed path keeps the tier at any
    length (L 6145 here)."""
    q, k, v, _, _ = _torch(_inputs(10, 1, 6145, 1, 64, False))
    got, _ = fa.flash_attention_streamed(q, k, v, int8="qk")
    assert not torch.equal(got, fa.flash_attention(q, k, v, int8="qk"))
    assert torch.equal(fa.flash_attention(q, k, v, int8="qk"), fa.flash_attention(q, k, v))


def test_full_tier_quantizes_p_against_the_final_max():
    """Hand check of "full" on one head: p against the row's final max,
    V per column over the whole length, O = f32(p_i·v_i)·(s_v/127)/Σp."""
    q, k, v, _, _ = _torch(_inputs(2, 1, 70, 1, 64, False))
    got, lse = fa.flash_attention_reference(q, k, v, int8="full")
    qi, sq = fa._quant(q.float(), -1)
    ki, sk = fa._quant(k.float(), -1)
    logits = (qi[0, :, 0] @ ki[0, :, 0].T) * (sq[0, :, 0] * 64 ** -0.5) * sk[0, :, 0].T
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    sv = v[0, :, 0].abs().amax(0).clamp_min(1e-20) / 127
    vi = torch.clamp(torch.round(v[0, :, 0] / sv), -127, 127)
    want = (torch.round(p * 127).double() @ vi.double()).float() * (sv / 127) / p.sum(-1, keepdim=True)
    np.testing.assert_allclose(got[0, :, 0].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse[0].numpy(), torch.logsumexp(logits, -1).numpy(), rtol=1e-6, atol=1e-5)


def test_tiers_stop_past_the_one_shot_length():
    """The JAX wrapper runs the tiers only when its padded length fits the
    one-shot path (round_up(L, blk_q) ≤ 6144, blk_q 256 there and 1024
    beyond); the port drops them at the same lengths."""
    from flux_generator_tpu.ops.pallas.flash_attention import BLK_Q, _round_up
    from flux_generator_tpu.runtime.config import flash_one_shot_max

    one_shot = flash_one_shot_max()
    for length in (1, 255, 1280, 6000, 6143, 6144, 6145, 7000, 16384):
        blk_q = 1024 if length > one_shot else BLK_Q
        jax_keeps = _round_up(length, blk_q) <= one_shot
        for tier in TIERS:
            assert fa.effective_int8(length, tier) == (tier if jax_keeps else "")
    with pytest.raises(ValueError):
        fa.effective_int8(100, "int8")


def test_tier_is_dropped_at_length_6145():
    """At L 6145 an int8 request computes the bf16 function exactly."""
    q, k, v, _, _ = _torch(_inputs(3, 1, 6145, 1, 64, False))
    assert torch.equal(fa.flash_attention(q, k, v, int8="full"), fa.flash_attention(q, k, v))


def _tier_grads(tier, entry, arrays, tgt):
    """(dq, dk, dv) of Σ (out − tgt)² through the port's `flash_attention`
    (one-shot) or `flash_attention_streamed` (groups of 64 keys) at `tier`."""
    q, k, v, cos, sin = arrays
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    c, s = torch.from_numpy(cos), torch.from_numpy(sin)
    if entry == "one_shot":
        out = fa.flash_attention(qt, kt, vt, c, s, int8=tier)
    else:
        out = fa.flash_attention_streamed(qt, kt, vt, c, s, int8=tier, blk_k=64)[0]
    loss = ((out - torch.from_numpy(tgt)) ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (qt, kt, vt))]


@pytest.mark.parametrize("entry", ["one_shot", "streamed"])
@pytest.mark.parametrize("tier", TIERS)
def test_gradient_through_a_tier_matches_jax(tier, entry):
    """The JAX backward is the bf16 one on the tier's out and lse, a
    straight-through estimate (`_flash_core_fwd`/`_flash_core_bwd`); the
    port's gradient against jax.grad through `_flash_attention_jit(...,
    int8_mxu=tier)` in interpret mode, on its one-shot path and on its
    streamed path (one-shot limit 64, q and key blocks of 64; "full" in
    two groups), L 100, RoPE, f32. atol = rtol = 2e-4, the bf16 path's
    backward tolerance (test_torch_flash_backward.py): the tier's out moves
    by a rounding step at most. The bf16 function's gradient must miss it."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import BLK_Q, _flash_attention_jit
    from flux_generator_tpu.runtime.config import flash_blk_k, flash_one_shot_max

    arrays = _inputs(4, 1, 100, 2, 64, True)
    tgt = np.random.default_rng(5).standard_normal(arrays[0].shape).astype(np.float32)
    if entry == "one_shot":
        kw = dict(blk_k=flash_blk_k(), one_shot_max=flash_one_shot_max(), blk_q=BLK_Q)
    else:
        kw = dict(blk_k=64, one_shot_max=64, blk_q=64)
    jcos, jsin = jnp.asarray(arrays[3]), jnp.asarray(arrays[4])

    def loss(q, k, v, int8_mxu):
        out = _flash_attention_jit(q, k, v, jcos, jsin, scale=None, interpret=True, int8_mxu=int8_mxu, **kw)
        return jnp.sum((out - jnp.asarray(tgt)) ** 2)

    def jax_grads(int8_mxu):
        g = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]), int8_mxu)
        return [np.asarray(x) for x in g]

    want = jax_grads(tier)
    got = _tier_grads(tier, entry, arrays, tgt)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=2e-4, err_msg=f"d{name} ({tier}, {entry})")
    # the check can fail: the bf16 function's gradient lies outside it
    bf16 = jax_grads("")
    assert any(not np.allclose(b, w, atol=2e-4, rtol=2e-4) for b, w in zip(bf16, want))


def test_unknown_tier_raises():
    q, k, v, cos, sin = _torch(_inputs(4, 1, 40, 2, 64, True))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, cos, sin, int8="fp8")
    with pytest.raises(ValueError):
        fa.flash_attention_streamed(q, k, v, cos, sin, int8="fp8")


# (out rel-L2, lse max|Δ|) of the kernel against the plain version, as
# chip_smoke.py's INT8_ATTN_TOL: out between the kernel's error and every
# control's distance, lse as the bf16 tier's (a rotated q value that rounds
# the other way moves its row's logits by one int8 level of q)
CUDA_TOL = {"qk": (4.5e-3, 2e-2), "full": (7e-3, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("b,l,h,d,rope", [(1, 1280, 24, 128, True), (1, 1000, 4, 128, True),
                                          (2, 300, 3, 64, False), (1, 1280, 4, 64, True),
                                          (3, 1, 2, 128, True)])
def test_cuda_tier_matches_plain_version(b, l, h, d, rope, tier):
    """The kernel against the plain version on the same bf16 inputs (both
    round rotated q/k to bf16 and quantize them with the same division):
    out by rel-L2, lse by max|Δ| (CUDA_TOL). "qk" rounds P to bf16 against
    a running max, "full" may move one int8 level of p near a .5 boundary,
    both round O to bf16. Every control (see _controls) must fail the same check, so
    that it tells the tier apart (at L 1 every function agrees)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _torch(_inputs(6, b, l, h, d, rope), "cuda", torch.bfloat16)
    before = (fa.launches, fa.int8_launches[tier])
    out, lse = fa.flash_attention(*args, return_lse=True, int8=tier)
    torch.cuda.synchronize()
    assert (fa.launches, fa.int8_launches[tier]) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = fa.flash_attention_reference(*args, int8=tier)
    tol_out, tol_lse = CUDA_TOL[tier]

    def within(o, ls):
        rel = ((o.float() - ref.float()).norm() / ref.float().norm()).item()
        return rel <= tol_out and (ls - ref_lse).abs().max().item() <= tol_lse

    assert within(out, lse)
    if l > 1:
        assert not [name for name, c in _controls(tier, args).items() if within(*c)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d,rope,blk_k", [(1, 1280, 24, 128, True, 64), (1, 1280, 24, 128, True, 1024),
                                                (1, 1000, 4, 128, True, 256), (2, 300, 3, 64, False, 128),
                                                (1, 4160, 2, 128, True, 1024)])
def test_cuda_streamed_full_matches_plain_version(b, l, h, d, rope, blk_k):
    """Kernel A's streamed "full" mode against `streamed_full_reference` on
    the same bf16 inputs, by CUDA_TOL["full"]: the same quantization and
    exact integer dots; exp and the sums in another order may move one int8
    level of p at a .5 boundary. The one-shot "full" tier (V over the whole
    head, p against the final max) must fail the check (at L 1280 in two
    groups it lies 1.9e-2 away, measured on an H100 80GB HBM3 at 700 W)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _torch(_inputs(11, b, l, h, d, rope), "cuda", torch.bfloat16)
    before = (fa.launches, fa.int8_launches["full_streamed"])
    out, lse = fa.flash_attention_streamed(*args, int8="full", blk_k=blk_k)
    torch.cuda.synchronize()
    assert (fa.launches, fa.int8_launches["full_streamed"]) == (before[0] + 1, before[1] + 1)
    ref, ref_lse = fa.streamed_full_reference(*args, blk_k=blk_k)
    tol_out, tol_lse = CUDA_TOL["full"]

    def within(o, ls):
        rel = ((o.float() - ref.float()).norm() / ref.float().norm()).item()
        return rel <= tol_out and (ls - ref_lse).abs().max().item() <= tol_lse

    assert within(out, lse)
    assert not within(*fa.flash_attention_reference(*args, int8="full"))


# ---- the int8 tiers' quantize pre-pass and the attention kernel behind it

PREPASS_CASES = [(d, l) for d in (64, 128) for l in (64, 65, 1000, 1280)]


def _bf16_inputs(seed, b, l, h, d, rope):
    return _torch(_inputs(seed, b, l, h, d, rope), dtype=torch.bfloat16)


@pytest.mark.parametrize("d,l", PREPASS_CASES)
def test_prepass_plain_matches_jax_quant_bit_for_bit(d, l):
    """The pre-pass's plain version against the JAX package's `_quant_rows`
    (q and k rotated and rounded to bf16, each head's rows) and
    `_quant_cols` (V over the whole head for "full"; per group of 384 keys
    for "full_streamed", the last group zero-padded as the streamed kernel's
    block), levels and f32 scales bit for bit; rows past L are quantized
    zeros."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import _quant_cols, _quant_rows

    b, h, group = 1, 2, 384
    q, k, v, cos, sin = _bf16_inputs(12, b, l, h, d, True)
    qr, kr = fa.rope_rotate_reference(q, k, cos, sin)
    l_pad = fa.padded_length(l)
    for tier in ("full", "full_streamed"):
        pre = fa.int8_prepass_reference(q, k, v, cos, sin, tier, group if tier == "full_streamed" else 0)
        for name, x in (("q", qr), ("k", kr)):
            rows = x.float().permute(0, 2, 1, 3).reshape(b * h * l, d).numpy()
            xi, sx = (np.asarray(a) for a in _quant_rows(jnp.asarray(rows)))
            got_i = pre[f"{name}i"][:, :l].reshape(-1, d).numpy()
            got_s = pre[f"{name}s"][:, :l].reshape(-1, 1).numpy()
            assert np.array_equal(got_i, xi) and np.array_equal(got_s, sx), (tier, name)
            assert not pre[f"{name}i"][:, l:].any() and pre[f"{name}i"].shape == (b * h, l_pad, d)
        g = l_pad if tier == "full" else group
        vi = torch.empty_like(pre["vt"])
        vi[:, :, fa.vt_key_order(l_pad)] = pre["vt"]
        for bh in range(b * h):
            head = v[bh // h, :, bh % h].float().numpy()
            for gi, k0 in enumerate(range(0, l, g)):
                block = np.zeros((g, d), np.float32)
                block[:min(g, l - k0)] = head[k0:k0 + g]
                want_i, want_s = (np.asarray(a) for a in _quant_cols(jnp.asarray(block)))
                n = min(g, l - k0)
                assert np.array_equal(vi[bh, :, k0:k0 + n].T.numpy(), want_i[:n]), (tier, bh, gi)
                assert np.array_equal(pre["vs"][bh, gi].numpy(), want_s[0]), (tier, bh, gi)
            assert not vi[bh, :, l:].any()


PLAIN_KERNEL_CASES = {"d128_rope": (1, 300, 2, 128, True), "b2_d64_l1000": (2, 1000, 1, 64, False),
                      "l65": (1, 65, 2, 64, True)}


@pytest.mark.parametrize("tier,group", [("qk", 0), ("full", 0), ("full_streamed", 64), ("full_streamed", 192)])
@pytest.mark.parametrize("case", list(PLAIN_KERNEL_CASES))
def test_plain_kernel_from_prepass_equals_references(case, tier, group):
    """The attention kernel's plain version, run from the pre-pass's outputs
    (int8 rows and scales, V transposed and key-permuted), equals
    `flash_attention_reference` / `streamed_full_reference` bit for bit (the
    same operations on the same values); the wrapper takes it for CPU
    tensors, launching nothing."""
    q, k, v, cos, sin = _bf16_inputs(13, *PLAIN_KERNEL_CASES[case])
    scale = q.shape[-1] ** -0.5
    before = (fa.launches, fa.int8_quant_launches)
    pre = fa.int8_prepass(q, k, v, cos, sin, tier, group)
    out, lse = fa.int8_attention(pre, v, scale, tier, group)
    assert (fa.launches, fa.int8_quant_launches) == before
    if tier == "full_streamed":
        ref, ref_lse = fa.streamed_full_reference(q, k, v, cos, sin, scale, blk_k=group)
    else:
        ref, ref_lse = fa.flash_attention_reference(q, k, v, cos, sin, scale, int8=tier)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_vt_key_permutation_by_hand():
    """Vᵀi's key order: within each 16 keys, position 4t + i holds key
    2t + (i & 1) + 8 (i >> 1), the keys whose S accumulators a thread holds
    (columns 8n + 2t, 8n + 2t + 1 of n8 groups n = 0, 1) in the order of its
    k32 A fragment (k-indices 4t..4t+3); checked by hand on one tile, and
    round-tripped through the pre-pass."""
    order = fa.vt_key_order(32).tolist()
    assert order[:16] == [0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15]
    assert order[16:] == [16 + x for x in order[:16]]
    assert sorted(fa.vt_key_order(256).tolist()) == list(range(256))
    # V's levels are the key index itself on one head (scale 1/127 · 127 = 1): Vᵀi row 0 reads the order
    l = 100
    v = torch.arange(l, dtype=torch.float32)[None, :, None, None].expand(1, l, 1, 64).contiguous()
    v[0, 0, 0, 1:] = 127.0  # column amax 127 in every column but 0, whose amax is key 99
    q = k = torch.ones((1, l, 1, 64))
    pre = fa.int8_prepass_reference(q, k, v, int8="full")
    vt = pre["vt"][0]
    assert vt.shape == (64, 128)
    assert vt[1, :32].tolist() == [127 if key == 0 else key for key in order]
    want_col0 = [round(key * 127 / 99) for key in fa.vt_key_order(128).tolist()]
    assert vt[0].tolist() == [x if key < l else 0 for x, key in zip(want_col0, fa.vt_key_order(128).tolist())]
    back = torch.empty_like(vt)
    back[:, fa.vt_key_order(128)] = vt
    assert back[1, :l].tolist() == [127] + list(range(1, l)) and not back[:, l:].any()


def test_streamed_group_must_be_whole_slabs():
    q, k, v, _, _ = _torch(_inputs(14, 1, 100, 1, 64, False))
    for group in (0, 96, -64):
        with pytest.raises(ValueError):
            fa.int8_prepass(q, k, v, int8="full_streamed", group=group)
    with pytest.raises(ValueError):
        fa.int8_prepass(q, k, v, int8="bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("tier,group", [("qk", 0), ("full", 0), ("full_streamed", 64), ("full_streamed", 1024)])
@pytest.mark.parametrize("b,l,h,d,rope", [(1, 1280, 24, 128, True), (1, 1000, 4, 128, True), (2, 129, 3, 64, False),
                                          (1, 65, 2, 64, True), (1, 6144, 2, 128, True)])
def test_cuda_prepass_matches_plain_version_bit_for_bit(b, l, h, d, rope, tier, group):
    """The pre-pass kernels against the plain version run on the CPU (IEEE
    division there; PyTorch's CUDA division by a scalar multiplies by its
    reciprocal): every level and scale bit for bit, padding rows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _torch(_inputs(15, b, l, h, d, rope), "cuda", torch.bfloat16)
    before = fa.int8_quant_launches
    pre = fa.int8_prepass(*args, int8=tier, group=group)
    torch.cuda.synchronize()
    assert fa.int8_quant_launches == before + (1 if tier == "qk" else 2)
    ref = fa.int8_prepass_reference(*(None if a is None else a.cpu() for a in args), int8=tier, group=group)
    assert sorted(pre) == sorted(ref)
    for name, want in ref.items():
        assert torch.equal(pre[name].cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("b,l,h,d", [(2, l, 2, d) for l in (64, 127, 129, 1000, 6144) for d in (64, 128)])
def test_cuda_tier_at_tile_edges(b, l, h, d, tier):
    """The pre-pass and the attention kernel through `flash_attention` at
    lengths around the 128-key tile and the 64-key slab, B 2 with per-batch
    tables, against the plain version by CUDA_TOL; one launch of each kind
    the pre-pass takes and one of the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _torch(_inputs(16, b, l, h, d, True), "cuda", torch.bfloat16)
    before = (fa.launches, fa.int8_launches[tier], fa.int8_quant_launches)
    out, lse = fa.flash_attention(*args, return_lse=True, int8=tier)
    torch.cuda.synchronize()
    assert (fa.launches, fa.int8_launches[tier], fa.int8_quant_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (1 if tier == "qk" else 2))
    ref, ref_lse = fa.flash_attention_reference(*args, int8=tier)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= CUDA_TOL[tier][0] and (lse - ref_lse).abs().max().item() <= CUDA_TOL[tier][1]


@pytest.mark.cuda
@pytest.mark.parametrize("blk_k", [64, 1024])
@pytest.mark.parametrize("b,l,h,d", [(2, 127, 2, 64), (2, 1000, 2, 128), (1, 1280, 24, 128), (2, 2100, 2, 64)])
def test_cuda_streamed_full_groups(b, l, h, d, blk_k):
    """A's streamed "full" mode in groups of 64 keys (64-key tiles) and of
    1024 (128-key tiles, the last group partial) against
    `streamed_full_reference` by CUDA_TOL["full"]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _torch(_inputs(17, b, l, h, d, True), "cuda", torch.bfloat16)
    out, lse = fa.flash_attention_streamed(*args, int8="full", blk_k=blk_k)
    torch.cuda.synchronize()
    ref, ref_lse = fa.streamed_full_reference(*args, blk_k=blk_k)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= CUDA_TOL["full"][0] and (lse - ref_lse).abs().max().item() <= CUDA_TOL["full"][1]
