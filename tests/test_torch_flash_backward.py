"""Flash-attention backward: the port's autograd function (plain version on
CPU tensors) against jax.grad through the JAX Pallas kernel in interpret
mode, the plain backward against torch autograd through the plain forward,
and kernels E and F against the plain backward on a card.

jax is imported inside the tests that use it, so the `cuda` cases run on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_flash_backward.py`."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import flash_attention as fa
from flux_generator_tpu_torch.ops.kernels import flash_attention_bwd as fb
from flux_generator_tpu_torch.ops.rope import multi_axis_rope, rope_cos_sin


def _inputs(seed, b, l, h, d, rope):
    rng = np.random.default_rng(seed)
    q, k, v, tgt = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(4))
    cos = sin = None
    if rope:
        pos = np.tile(np.arange(l, dtype=np.float32), (b, 1))
        c, s = rope_cos_sin(torch.from_numpy(pos), d)
        cos, sin = c.numpy(), s.numpy()
    return q, k, v, tgt, cos, sin


def _port_grads(q, k, v, tgt, cos, sin):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    c = None if cos is None else torch.from_numpy(cos)
    s = None if sin is None else torch.from_numpy(sin)
    out = fa.flash_attention(qt, kt, vt, c, s)
    loss = ((out - torch.from_numpy(tgt)) ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (qt, kt, vt))]


@pytest.mark.parametrize("l,rope", [(192, False), (192, True), (100, True)])
def test_grads_match_jax_pallas_backward(l, rope):
    """d=64, B=2, H=2; L=192 pads to 256 in the JAX kernel, L=100 is no
    multiple of 64. atol = rtol = 2e-4, the tolerance of
    tests/test_pallas_flash.py's backward test: f32 on both sides."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    q, k, v, tgt, cos, sin = _inputs(7, 2, l, 2, 64, rope)
    jcos = None if cos is None else jnp.asarray(cos)
    jsin = None if sin is None else jnp.asarray(sin)

    def loss(q, k, v):
        out = jax_flash(q, k, v, cos=jcos, sin=jsin, interpret=True)
        return jnp.sum((out - jnp.asarray(tgt)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _port_grads(q, k, v, tgt, cos, sin)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name} (l={l}, rope={rope})")


@pytest.mark.parametrize("rope", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(rope):
    """The plain backward alone, on rotated q/k with the forward's lse and
    dvec = rowsum(dO·O), equals torch autograd through the plain forward
    (f32, atol 1e-5)."""
    b, l, h, d = 2, 50, 3, 64
    q, k, v, tgt, cos, sin = (None if a is None else torch.from_numpy(a)
                              for a in _inputs(3, b, l, h, d, rope))
    if rope:
        q, k = fa._rope_f32(q, cos, sin), fa._rope_f32(k, cos, sin)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    out, lse = fa.flash_attention_reference(qg, kg, vg)
    dout = 2 * (out - tgt)
    want = torch.autograd.grad(out, (qg, kg, vg), dout)
    dvec = (dout * out).sum(-1).transpose(1, 2).reshape(b * h, l).detach()
    got = fb.flash_attention_bwd_reference(q, k, v, dout.detach(), lse.detach(), dvec, d ** -0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_backward_without_counting():
    before = (fb.dq_launches, fb.dkv_launches)
    q, k, v, tgt, cos, sin = _inputs(5, 1, 20, 2, 64, True)
    _port_grads(q, k, v, tgt, cos, sin)
    assert (fb.dq_launches, fb.dkv_launches) == before


def test_no_gradient_for_the_tables():
    q, k, v, _, cos, sin = (torch.from_numpy(a) for a in _inputs(6, 1, 16, 2, 64, True))
    cos.requires_grad_(True)
    q.requires_grad_(True)
    out = fa.flash_attention(q, k, v, cos, sin)
    gq, gc = torch.autograd.grad(out.sum(), (q, cos), allow_unused=True)
    assert gq is not None and gc is None


@pytest.mark.parametrize("bad", ["f32", "head_dim_32", "non_contiguous", "lse_shape", "lse_f16"])
def test_kernel_argument_checks_raise(bad):
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    k, v, do = q.clone(), q.clone(), q.clone()
    lse = dvec = torch.zeros(2, 8)
    if bad == "f32":
        q, k, v, do = q.float(), k.float(), v.float(), do.float()
    elif bad == "head_dim_32":
        q = k = v = do = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    elif bad == "non_contiguous":
        q = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    elif bad == "lse_shape":
        lse = torch.zeros(8, 2)
    elif bad == "lse_f16":
        lse = lse.half()
    with pytest.raises(ValueError):
        fb._check_cuda_args(q, k, v, do, lse, dvec)


@pytest.mark.parametrize("bad", ["base_address", "row_stride"])
def test_tma_alignment_checks_raise(bad):
    """Kernels E and F read q, k, v and dO by TMA, which takes 16-byte aligned
    base addresses and strides: the wrapper raises, there is no fallback."""
    flat = torch.zeros(1 + 8 * 2 * 128, dtype=torch.bfloat16)
    good = flat[:-1].view(1, 8, 2, 128)
    lse = dvec = torch.zeros(2, 8)
    fb._check_cuda_args(good, good, good, good, lse, dvec)
    if bad == "base_address":
        q, match = flat[1:].view(1, 8, 2, 128), "aligned"
    else:
        q, match = torch.zeros(1, 8, 2, 132, dtype=torch.bfloat16)[..., :128], "strides"  # rows of 264 bytes
    with pytest.raises(ValueError, match=match):
        fb._check_cuda_args(q, good, good, good, lse, dvec)


@pytest.mark.parametrize("units,n_tiles,sms,want", [
    (288, 24, 132, (264, 5)),   # Flux-dev training, L 1536, 24 heads: 2 waves and 24 units in 5 parts
    (264, 24, 132, (264, 1)),   # two whole waves: no split
    (240, 20, 132, (240, 1)),   # L 1280: the last wave 108 of 132
    (192, 16, 132, (192, 1)),   # L 1000: 60 units would go in 2 parts, fewer than MIN_PARTS
    (160, 16, 132, (160, 1)),   # D 64, B 2, 10 heads: 28 units would go in 4
    (18, 5, 132, (0, 5)),       # under a wave: parts of one tile each
    (24, 2, 132, (24, 1)),      # short loops: never more parts than tiles
])
def test_split_plan(units, n_tiles, sms, want):
    """The units of the last, partial wave run in as many parts of their loop
    as fill the SMs, never more parts than tiles, and only when that makes
    MIN_PARTS parts or more."""
    full, chunks = fb.split_plan(units, n_tiles, sms)
    assert (full, chunks) == want
    assert full + (units - full) * chunks <= max(units, (units // sms + 1) * sms)


def test_prof_flash_bwd_plans_and_needs_the_card():
    """The split probe's settings at chip_smoke's training shapes on 132
    SMs: 2 parts or more split L 1536, L 1000 and D 64; MIN_PARTS only L
    1536; and it times nothing without a card."""
    from flux_generator_tpu_torch.scripts import prof_flash_bwd as pf

    assert pf.plans((1, 1536, 24, 128), 132, 2) == ((264, 5), (264, 5))
    assert pf.plans((1, 1536, 24, 128), 132, fb.MIN_PARTS) == ((264, 5), (264, 5))
    assert pf.plans((1, 1536, 24, 128), 132, None) == ((288, 1), (288, 1))
    assert pf.plans((1, 1000, 24, 128), 132, 2) == ((132, 2), (132, 2))
    assert pf.plans((1, 1000, 24, 128), 132, fb.MIN_PARTS) == ((192, 1), (192, 1))
    assert pf.plans((2, 1024, 10, 64), 132, 2) == ((132, 4), (132, 4))
    assert pf.plans((1, 1280, 24, 128), 132, 2) == ((240, 1), (240, 1))
    with pytest.raises(RuntimeError, match="card"):
        pf.run(device="cpu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_glue_equals_the_old_formulation_bit_for_bit(dtype):
    """The backward's rotation of q and k and its pull-back of dq and dk go
    through the RoPE pre-pass (`rope_rotate`, with (cos, −sin) for the
    pull-back); on CPU tensors that is bit for bit the formulation it
    replaced: the tables cast to the working dtype, `_rope_f32(...)` rounded
    to it, and (cos, −sin) in the working dtype."""
    b, l, h, d = 2, 40, 3, 64
    q, k, v, tgt, cos, sin = (torch.from_numpy(a) for a in _inputs(11, b, l, h, d, True))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out, lse = fa.flash_attention_reference(q, k, v, cos, sin)
    dout = (2 * (out.float() - tgt)).to(dtype)
    got = fa.flash_attention_backward(q, k, v, cos, sin, out, lse, dout, d ** -0.5)

    c, s = cos.to(dtype), sin.to(dtype)
    qr, kr = fa._rope_f32(q, c, s).to(dtype), fa._rope_f32(k, c, s).to(dtype)
    dvec = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, l).contiguous()
    dq, dk, dv = fb.flash_attention_bwd(qr, kr, v, dout, lse, dvec, d ** -0.5)
    want = (fa._rope_f32(dq, c, -s).to(dtype), fa._rope_f32(dk, c, -s).to(dtype), dv)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == dtype and torch.equal(g, w), f"d{name}"


def _flux_tables(length, dev):
    """cos/sin (1, length, 64) from the Flux ids: 512 text tokens (id 0) then
    a 32x32 patch grid, cut to `length`."""
    j, i = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    img = torch.stack([torch.zeros_like(j), j, i], -1).reshape(1, -1, 3)
    ids = torch.cat([torch.zeros((1, 512, 3), dtype=torch.int64), img], 1)[:, :length]
    cos, sin = multi_axis_rope(ids.to(dev), [16, 56, 56])
    return cos, sin


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d,rope", [(1, 1536, 24, 128, True), (1, 1280, 24, 128, True),
                                          (1, 1000, 4, 128, True), (2, 300, 3, 64, False),
                                          (1, 77, 2, 64, True), (2, 65, 3, 128, False)])
def test_cuda_kernels_match_plain_backward(b, l, h, d, rope):
    """Kernels E and F through the autograd function, bf16, against the plain
    backward in f32 on the same bf16 inputs: max|Δ| ≤ 2e-2 of max|ref| per
    gradient (P and dS are rounded to bf16 before their products, the
    outputs are stored in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(l)
    q, k, v, dout = (torch.randn((b, l, h, d), generator=g, device=dev).to(torch.bfloat16)
                     for _ in range(4))
    if rope and d == 128 and b == 1:
        cos, sin = _flux_tables(l, dev)
    elif rope:
        cos, sin = rope_cos_sin(torch.arange(l, device=dev).float()[None].expand(b, l), d)
    else:
        cos = sin = None
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    before = (fb.dq_launches, fb.dkv_launches)
    out = fa.flash_attention(qg, kg, vg, cos, sin)
    got = torch.autograd.grad(out, (qg, kg, vg), dout)
    torch.cuda.synchronize()
    assert (fb.dq_launches, fb.dkv_launches) == (before[0] + 1, before[1] + 1)

    # torch autograd through the plain forward, in f32 on the card
    tab = (lambda t: None if t is None else t.to(torch.bfloat16).float())
    qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
    out_ref, _ = fa.flash_attention_reference(qf, kf, vf, tab(cos), tab(sin))
    want = torch.autograd.grad(out_ref, (qf, kf, vf), dout.float())
    for gg, w, name in zip(got, want, "qkv"):
        err = (gg.float() - w).abs().max().item()
        assert err <= 2e-2 * w.abs().max().item(), f"d{name}: {err}"


def _bwd_inputs(b, l, h, d, seed):
    """bf16 q, k, v, dO on the card with the forward's lse and dvec from the
    plain forward in f32."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((b, l, h, d), generator=g, device=dev).to(torch.bfloat16)
                     for _ in range(4))
    out, lse = fa.flash_attention_reference(q.float(), k.float(), v.float())
    dvec = (dout.float() * out).sum(-1).transpose(1, 2).reshape(b * h, l).contiguous()
    return q, k, v, dout, lse, dvec


@pytest.mark.cuda
@pytest.mark.parametrize("l,d", [(1000, 64), (1000, 128), (320, 64), (320, 128)])
def test_cuda_kernels_ragged_length(l, d):
    """E and F on unrotated inputs against the plain backward in f32: L 1000
    ends inside a 64-query tile of F (and a 64-key tile of E), L 320 on a
    64-row tile's edge but inside a 128-row block; max|Δ| ≤ 2e-2 of max|ref|
    per gradient, as through the autograd function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, dout, lse, dvec = _bwd_inputs(2, l, 3, d, l + d)
    args = (q, k, v, dout, lse, dvec, d ** -0.5)
    want = fb.flash_attention_bwd_reference(q.float(), k.float(), v.float(), dout.float(), lse, dvec,
                                            d ** -0.5)
    # as planned (at L 320 18 units under a wave go in 5 parts of the loop), and whole
    for got in (fb.flash_attention_bwd(*args),
                (fb.flash_attention_bwd_dq_cuda(*args, split=False),
                 *fb.flash_attention_bwd_dkv_cuda(*args, split=False))):
        torch.cuda.synchronize()
        for gg, w, name in zip(got, want, "qkv"):
            assert gg.shape == w.shape and gg.dtype == torch.bfloat16
            err = (gg.float() - w.float()).abs().max().item()
            assert err <= 2e-2 * w.float().abs().max().item(), f"d{name}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernels_are_deterministic(d):
    """No atomics: each output is summed by the one block that owns it in a
    fixed order, so two calls give the same bits (F launched as E's
    programmatic dependent, and alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, dout, lse, dvec = _bwd_inputs(1, 777, 2, d, 5)  # 14 units, split in 9 parts
    first = fb.flash_attention_bwd(q, k, v, dout, lse, dvec, d ** -0.5)
    second = fb.flash_attention_bwd(q, k, v, dout, lse, dvec, d ** -0.5)
    alone = (fb.flash_attention_bwd_dq_cuda(q, k, v, dout, lse, dvec, d ** -0.5),
             *fb.flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, dvec, d ** -0.5))
    torch.cuda.synchronize()
    for a, b_, c, name in zip(first, second, alone, "qkv"):
        assert torch.equal(a, b_) and torch.equal(a, c), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernel_info_reports_no_spills(d):
    """ptxas keeps both kernels in registers (0 bytes of local memory a
    thread), and one block of each fits an SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = fb.kernel_info(d)
    for name in ("dq", "dkv"):
        assert info[name]["spill_bytes"] == 0, (name, info[name])
        assert info[name]["blocks_per_sm"] >= 1, (name, info[name])
