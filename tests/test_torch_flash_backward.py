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
