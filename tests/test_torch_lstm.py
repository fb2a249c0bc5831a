"""The LSTM recurrence: the port's plain version against the JAX Pallas kernel
`lstm_pallas` (interpret mode on CPU) and the lax.scan `lstm_forward`, and
the CUDA kernel (kernel C) against the plain version on a card.

Tolerances. At small d both sides run in f32: atol 1e-5, as in
tests/test_pallas_lstm.py. Above the 4 Mi threshold xw and Wh are bf16 on
both sides and only the summation order differs: atol 1e-4. Kernel against
the plain version on a card: f32 states and accumulation in another order,
atol 2e-3 for bf16 Wh (a bf16-rounded h can flip by one ulp, 2^-8, and
carry into later steps) and 1e-4 for f32.

jax is imported inside the tests that use it, so the `cuda` cases run on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_lstm.py`."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.models.musicgen.encodec import lstm_forward
from flux_generator_tpu_torch.ops.kernels import lstm as lk


def _params(seed, d_in, d, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"wx": (rng.standard_normal((d_in, 4 * d)) * scale).astype(np.float32),
            "wh": (rng.standard_normal((d, 4 * d)) * scale).astype(np.float32),
            "bias": (rng.standard_normal((4 * d,)) * 0.1).astype(np.float32)}


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("t", [16, 200])
def test_plain_version_matches_jax_kernel_and_scan(t):
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen.encodec import lstm_forward as jax_lstm_forward
    from flux_generator_tpu.ops.pallas.lstm import lstm_pallas

    d = 8
    p = _params(0, d, d)
    x = np.random.default_rng(1).standard_normal((2, t, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = lk.lstm_plain(_torch(p), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(lstm_pallas(jp, jnp.asarray(x), interpret=True)),
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_lstm_forward(jp, jnp.asarray(x))), atol=1e-5)
    # the encodec entry point is the same function
    np.testing.assert_array_equal(lstm_forward(_torch(p), torch.from_numpy(x)).numpy(), got)


def test_bf16_rule_above_threshold_matches_jax_kernel():
    """d = 1024 (16·d² > 4 Mi): xw and Wh are rounded to bf16, h is rounded
    to bf16 before each product, the states stay f32 — as lstm_pallas."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas.lstm import lstm_pallas

    d, t = 1024, 4
    assert lk.wh_dtype_for(d) == torch.bfloat16 and lk.wh_dtype_for(512) == torch.float32
    p = _params(2, 16, d, scale=0.03)
    x = np.random.default_rng(3).standard_normal((1, t, 16)).astype(np.float32)
    want = np.asarray(lstm_pallas({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                  interpret=True))
    got = lk.lstm_plain(_torch(p), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # and the rule is not a no-op: the all-f32 recurrence differs from it
    xw32 = torch.from_numpy(x) @ _torch(p)["wx"] + _torch(p)["bias"]
    exact = lk.lstm_recurrence_plain(xw32, _torch(p)["wh"], torch.float32)
    assert (exact - got).abs().max() > 1e-4


def test_cpu_tensors_take_the_plain_version_without_counting():
    p = _torch(_params(4, 8, 8))
    x = torch.randn(1, 5, 8)
    before = lk.launches
    assert torch.equal(lk.lstm(p, x), lk.lstm_plain(p, x))
    assert lk.launches == before


@pytest.mark.parametrize("bad", ["mixed_dtypes", "f16", "not_4d", "xw_width", "strided"])
def test_kernel_argument_checks_raise(bad):
    d = 8
    xw = torch.zeros(1, 5, 4 * d)
    wh = torch.zeros(d, 4 * d)
    out_dtype = torch.float32
    if bad == "mixed_dtypes":
        wh = wh.to(torch.bfloat16)
    elif bad == "f16":
        xw, wh = xw.half(), wh.half()
    elif bad == "not_4d":
        wh = torch.zeros(d, 3 * d)
    elif bad == "xw_width":
        xw = torch.zeros(1, 5, 4 * d + 4)
    elif bad == "strided":
        xw = torch.zeros(1, 4 * d, 5).transpose(1, 2)
    with pytest.raises(ValueError):
        lk._check_cuda_args(xw, wh, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,b,wh_dtype,out_dtype,atol", [
    (1024, 497, 1, torch.bfloat16, torch.float32, 2e-3),
    (1024, 33, 2, torch.bfloat16, torch.bfloat16, 1e-2),
    (256, 120, 1, torch.float32, torch.float32, 1e-4),
])
def test_cuda_kernel_matches_plain_version(d, t, b, wh_dtype, out_dtype, atol):
    """Kernel C against the plain version on the same xw/Wh on the card;
    bf16 output adds its own rounding (2^-8 of |h| < 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    xw = (torch.randn((b, t, 4 * d), generator=g, device="cuda") * 0.5).to(wh_dtype)
    wh = (torch.randn((d, 4 * d), generator=g, device="cuda") / d ** 0.5).to(wh_dtype)
    before = lk.launches
    got = lk.lstm_recurrence(xw, wh, out_dtype)
    torch.cuda.synchronize()
    assert lk.launches == before + 1
    want = lk.lstm_recurrence_plain(xw, wh, out_dtype)
    assert (got.float() - want.float()).abs().max().item() <= atol
