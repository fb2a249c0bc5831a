"""The int8 tiers of flash attention ("qk": int8 Q·Kᵀ; "full": also int8
P·V): the port's plain version against the JAX Pallas kernel (interpret
mode on CPU) under `set_attn_int8`, the one-shot length guard, the refused
gradient, and the CUDA kernel against the plain version on a card.

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
