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


def test_exchange_floor_needs_a_cuda_device():
    with pytest.raises(ValueError):
        lk.exchange_floor(1, 4, 1024, "cpu")


H100_SMS = 132  # an H100 SXM; an H100 PCIe has 114


@pytest.mark.parametrize("d,sms,want", [
    (1024, H100_SMS, (8, 32)),  # EnCodec's LSTM: Wh in registers, 128 blocks of 8 units
    (512, H100_SMS, (4, 16)),
    (998, H100_SMS, (8, 32)),
    (6, H100_SMS, (1, 8)),
    (1024, 114, (9, 0)),  # an H100 PCIe: 9 units a block, Wh in shared memory
    (512, 114, (5, 16)),
    (1536, H100_SMS, (12, 0)),  # past 1024: Wh in shared memory
    (512, 40, (13, 0)),
])
def test_lstm_geometry_is_pinned(d, sms, want):
    """C's launch: ⌈d / SMs⌉ units a block; Wh in registers (kpl rows a
    lane a column) where d ≤ 1024 and a block has at most 8 units, else in
    shared memory (kpl 0)."""
    assert lk.lstm_geometry(d, sms) == want


@pytest.mark.parametrize("sms", [H100_SMS, 114, 100, 16])
@pytest.mark.parametrize("d", [1, 6, 255, 512, 998, 1024, 1025, 1600])
def test_lstm_geometry_fits_any_card(sms, d):
    """Whatever the card: one block an SM at most, every unit in a block,
    and Wh in registers only where a lane's rows cover d and the block has
    at most 8 warps; too wide a d for 16 warps a block raises."""
    if -(-d // sms) > lk.MAX_UNITS:
        with pytest.raises(ValueError):
            lk.lstm_geometry(d, sms)
        return
    units, kpl = lk.lstm_geometry(d, sms)
    assert 1 <= units <= lk.MAX_UNITS and -(-d // units) <= sms and units * sms >= d
    if kpl:
        assert kpl in (8, 16, 32) and 32 * kpl >= d and units <= lk.MAX_REG_UNITS and d <= lk.MAX_REG_D
    else:
        assert d > lk.MAX_REG_D or units > lk.MAX_REG_UNITS


def test_plain_version_keeps_batch_rows_independent():
    """A NaN in one batch row's xw leaves the other rows' h as they are
    alone (within the product's rounding) and fills its own row's h from the
    next step: what the kernel has to keep (its reads of h stop at a row's
    end)."""
    rng = np.random.default_rng(9)
    xw = torch.from_numpy(rng.standard_normal((2, 6, 4 * 10)).astype(np.float32))
    wh = torch.from_numpy((rng.standard_normal((10, 4 * 10)) * 0.3).astype(np.float32))
    alone = lk.lstm_recurrence_plain(xw[:1], wh, torch.float32)
    xw[1, 2, 5] = float("nan")
    both = lk.lstm_recurrence_plain(xw, wh, torch.float32)
    assert (both[0] - alone[0]).abs().max().item() <= 1e-6 and both[1, 3:].isnan().all()


@pytest.mark.parametrize("b,d,kpl,words", [(1, 1024, 32, 2048), (2, 998, 0, 4000), (3, 6, 0, 48), (1, 1, 8, 8),
                                           (1, 998, 32, 2000), (2, 998, 32, 4096), (3, 6, 8, 1536)])
def test_flagged_words_are_zeroed_rows_of_four(b, d, kpl, words):
    """The words of one call: two parities of B rows of d words, each row
    rounded up to a multiple of 4 (16-byte aligned rows, polled two words a
    load), or with Wh in registers and B > 1 to the 32·kpl rows a lane's
    reads span (so that they stay in their batch row), all zero so that no
    tag (from 1) matches before it is written."""
    got = lk._words(b, d, kpl, "cpu")
    assert got.dtype == torch.int64 and got.numel() == words and not got.any()


def _cuda_inputs(seed, d, t, b, wh_dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xw = (torch.randn((b, t, 4 * d), generator=g, device="cuda") * 0.5).to(wh_dtype)
    wh = (torch.randn((d, 4 * d), generator=g, device="cuda") / d ** 0.5).to(wh_dtype)
    return xw, wh


# around the xw ring's depth of lk.RING (step, batch) pairs
RING_TS = [1, 2, lk.RING - 1, lk.RING, lk.RING + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,b,wh_dtype,out_dtype,atol", [
    (1024, 497, 1, torch.bfloat16, torch.float32, 2e-3),
    (1024, 33, 2, torch.bfloat16, torch.bfloat16, 1e-2),
    (256, 120, 1, torch.float32, torch.float32, 1e-4),
    *((1024, t, 1, torch.bfloat16, torch.float32, 2e-3) for t in RING_TS),
    (1024, 2497, 1, torch.bfloat16, torch.float32, 2e-3),
    (1024, 9, 3, torch.bfloat16, torch.float32, 2e-3),
    (512, 497, 1, torch.float32, torch.float32, 1e-4),
    (998, 20, 2, torch.bfloat16, torch.float32, 2e-3),
    (6, 11, 3, torch.float32, torch.bfloat16, 1e-2),
])
def test_cuda_kernel_matches_plain_version(d, t, b, wh_dtype, out_dtype, atol):
    """Kernel C against the plain version on the same xw/Wh on the card;
    bf16 output adds its own rounding (2^-8 of |h| < 1). At T 1, 2 and
    around the xw ring's depth, at a 500-step (T 497) and a 2500-step
    (T 2497) request's length, at B 2 and 3 (the ring RING / B steps
    ahead), and at widths whose last block has fewer units and whose rows
    of h words are padded (998, 6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xw, wh = _cuda_inputs(5, d, t, b, wh_dtype)
    before = lk.launches
    got = lk.lstm_recurrence(xw, wh, out_dtype)
    torch.cuda.synchronize()
    assert lk.launches == before + 1
    want = lk.lstm_recurrence_plain(xw, wh, out_dtype)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_cuda_calls_agree_bit_for_bit_and_narrower_after_wider():
    """Two back-to-back calls give the same bits (a fixed order of
    summation; a tag that matched a step early would show here), and a d 512
    f32 call right after a d 1024 bf16 one is right (fresh words, its own
    grid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xw, wh = _cuda_inputs(6, 1024, 300, 1, torch.bfloat16)
    first = lk.lstm_recurrence(xw, wh, torch.float32)
    second = lk.lstm_recurrence(xw, wh, torch.float32)
    xw2, wh2 = _cuda_inputs(7, 512, 300, 1, torch.float32)
    narrow = lk.lstm_recurrence(xw2, wh2, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert (narrow - lk.lstm_recurrence_plain(xw2, wh2, torch.float32)).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_phase_times_and_serial_floor_run():
    """The PHASES and FLOOR modes launch (each counted) and report a
    positive split; the phase launch's output is not returned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xw, wh = _cuda_inputs(8, 1024, 50, 1, torch.bfloat16)
    before = lk.launches
    phases = lk.phase_times(xw, wh)
    lk.exchange_floor(1, 50, 1024, "cuda")
    torch.cuda.synchronize()
    assert lk.launches == before + 2
    assert set(phases) == set(lk.PHASE_NAMES) and sum(phases.values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,b,sms", [(1024, 1, 114), (998, 2, 114), (1024, 1, 64)])
def test_cuda_shared_memory_route_equals_register_route(d, b, sms):
    """Wh in shared memory (the launch of a card with `sms` SMs, forced on
    this one) gives the register route's bits: the same products in the
    same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xw, wh = _cuda_inputs(10, d, 120, b, torch.bfloat16)
    geometry = lk.lstm_geometry(d, sms)
    assert geometry[1] == 0
    shared = lk._run(xw, wh, torch.float32, geometry=geometry)
    registers = lk._run(xw, wh, torch.float32, geometry=lk.lstm_geometry(d, 132))
    torch.cuda.synchronize()
    assert torch.equal(shared, registers)


@pytest.mark.cuda
@pytest.mark.parametrize("d,t,b,wh_dtype,sms,atol", [
    (1536, 60, 1, torch.bfloat16, None, 2e-3),  # past 1024: Wh in shared memory on any H100
    (1100, 30, 2, torch.bfloat16, None, 2e-3),
    (512, 80, 1, torch.float32, 40, 1e-4),  # f32 Wh in shared memory, 13 units a block
])
def test_cuda_shared_memory_route_matches_plain_version(d, t, b, wh_dtype, sms, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xw, wh = _cuda_inputs(11, d, t, b, wh_dtype)
    geometry = lk.lstm_geometry(d, sms) if sms else None
    got = lk._run(xw, wh, torch.float32, geometry=geometry)
    torch.cuda.synchronize()
    assert (got - lk.lstm_recurrence_plain(xw, wh, torch.float32)).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [132, 114])
def test_cuda_nan_in_one_batch_row_stays_in_it(sms):
    """At d 998 a lane's last 16-byte read of h would reach past its batch
    row; a NaN in row 1's xw must leave row 0 as the plain version has it,
    on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xw, wh = _cuda_inputs(12, 998, 20, 2, torch.bfloat16)
    xw[1, 3, 7] = float("nan")
    got = lk._run(xw, wh, torch.float32, geometry=lk.lstm_geometry(998, sms))
    want = lk.lstm_recurrence_plain(xw, wh, torch.float32)
    torch.cuda.synchronize()
    assert want[0].isfinite().all() and got[1, 4:].isnan().all()
    assert (got[0] - want[0]).abs().max().item() <= 2e-3
