"""The int8 tiers of flash attention ("qk": int8 Q·Kᵀ; "full": also int8
P·V): the port's plain version against the JAX Pallas kernel (interpret
mode on CPU) under `set_attn_int8`, the one-shot length guard, the refused
gradient, and the CUDA kernel against the plain version on a card; and
`flash_attention_streamed`, the JAX streamed path whose tiers run at any
length ("full" quantized per group of blk_k keys), against
`_flash_attention_jit` on its streamed path, and its kernel mode on a card.

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


@pytest.mark.parametrize("tier", TIERS)
def test_gradient_through_a_tier_raises(tier):
    """The JAX backward is bf16/f32 whatever the tier; the port refuses a
    gradient rather than return one for another function."""
    q, k, v, cos, sin = _torch(_inputs(4, 1, 40, 2, 64, True))
    q.requires_grad_(True)
    out = fa.flash_attention(q, k, v, cos, sin, int8=tier)
    with pytest.raises(RuntimeError, match="no gradient"):
        out.sum().backward()
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, cos, sin, int8="fp8")


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
