"""The decode-chain probe (#11): the plain chain against the JAX script's
`jnp_chain` and its Pallas kernel `pallas_chain` (interpret mode) at 2
layers of the script's H 1536 and M 8, the wrapper's dispatch and argument
checks, the probe entry point's guards, and the CUDA kernel against the
plain chain on a card.

The script (scripts/prof_pallas_chain.py) sets jax's compilation-cache
directory and threshold when imported; it is loaded by path and both
settings are put back afterwards.

Tolerances, of max|y|: against `jnp_chain` 1e-2 — the same bf16-rounded dot
inputs and weights and f32 sums in another order, through 2 layers, with a
bf16 output (2^-8 relative); against `pallas_chain` the same, its GELU
polynomial within 1.5e-7 of erf. Kernel against the plain chain on a card:
1e-2, the same arithmetic in another summation order (kernel D's bound).

jax is imported inside the tests that use it, so the `cuda` case runs on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_decode_chain.py`."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import decode_chain as dc
from flux_generator_tpu_torch.ops.kernels.decode_step import CPL

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-2


@pytest.fixture(scope="module")
def script():
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("prof_pallas_chain", REPO / "scripts" / "prof_pallas_chain.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _inputs(layers=2, seed=0):
    """The script's distributions (main(), l.242-251), from numpy."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, size=(layers * CPL, 1536, 1536), dtype=np.int8)
    s = (rng.random((layers * CPL, 1, 1536), dtype=np.float32) * 0.02 + 0.01)
    x = rng.normal(size=(8, 1536)).astype(np.float32)
    return w, s, x


def test_loading_the_script_keeps_jax_settings(script):
    import jax

    assert jax.config.jax_compilation_cache_dir != str(REPO / ".jax_cache")
    assert script.H == 1536 and script.CPL == CPL and script.M == 8


@pytest.mark.parametrize("opponent", ["jnp_chain", "pallas_chain"])
def test_plain_chain_matches_the_script(script, opponent):
    import jax.numpy as jnp

    w, s, x = _inputs()
    wj, sj, xj = jnp.asarray(w), jnp.asarray(s).astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    fn = script.jnp_chain if opponent == "jnp_chain" else lambda *a: script.pallas_chain(*a, interpret=True)
    want = np.asarray(fn(wj, sj, xj).astype(jnp.float32))
    st = torch.from_numpy(np.array(sj.astype(jnp.float32))).to(torch.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = dc.decode_chain(torch.from_numpy(w), st, xt)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1536)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def test_parked_projections_still_carry_nan():
    """c1 and c2 are computed, not dropped: a NaN in them reaches y, as in
    the script's `0.0 * kpark` term."""
    w, s, x = _inputs(layers=1)
    s[1, 0, 0] = np.nan
    y = dc.decode_chain(torch.from_numpy(w), torch.from_numpy(s).to(torch.bfloat16),
                        torch.from_numpy(x).to(torch.bfloat16))
    assert torch.isnan(y.float()).any()


def test_cpu_tensors_take_the_plain_version_without_counting():
    w, s, x = _inputs(layers=1, seed=2)
    wt, st, xt = torch.from_numpy(w), torch.from_numpy(s).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    before = dc.launches
    assert torch.equal(dc.decode_chain(wt, st, xt), dc.decode_chain_plain(wt, st, xt))
    assert dc.launches == before


@pytest.mark.parametrize("bad", ["f32_x", "bf16_w", "rows_9", "h_384", "w_layers", "s_shape", "strided_x"])
def test_kernel_argument_checks_raise(bad):
    h, m, n = 256, 8, CPL
    w = torch.zeros((n, h, h), dtype=torch.int8)
    s = torch.ones((n, 1, h), dtype=torch.bfloat16)
    x = torch.zeros((m, h), dtype=torch.bfloat16)
    if bad == "f32_x":
        x = x.float()
    elif bad == "bf16_w":
        w = w.to(torch.bfloat16)
    elif bad == "rows_9":
        x = torch.zeros((9, h), dtype=torch.bfloat16)
    elif bad == "h_384":
        w, s, x = torch.zeros((n, 384, 384), dtype=torch.int8), torch.ones((n, 1, 384), dtype=torch.bfloat16), \
            torch.zeros((m, 384), dtype=torch.bfloat16)
    elif bad == "w_layers":
        w = w[:n - 1]
    elif bad == "s_shape":
        s = s[:, 0]
    elif bad == "strided_x":
        x = torch.zeros((m, 2 * h), dtype=torch.bfloat16)[:, ::2]
    with pytest.raises(ValueError):
        dc._check_cuda_args(w, s, x)
    dc._check_cuda_args(torch.zeros((n, h, h), dtype=torch.int8), torch.ones((n, 1, h), dtype=torch.bfloat16),
                        torch.zeros((m, h), dtype=torch.bfloat16))


def test_probe_entry_point_runs_on_the_card_only(monkeypatch):
    from flux_generator_tpu_torch.scripts import prof_decode_chain as probe

    with pytest.raises(RuntimeError, match="card"):
        probe.run(layers=1, steps=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--layers", "1", "--steps", "1"])
    w, s, x = probe.make_inputs(1, torch.device("cpu"))
    assert w.shape == (CPL, 1536, 1536) and s.shape == (CPL, 1, 1536) and x.shape == (8, 1536)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,m", [(2, 8), (2, 2), (3, 5)])
def test_cuda_kernel_matches_plain_version(layers, m):
    """The chain kernel at H 1536 against the plain chain on the card, on
    unit-scale weights (prof_decode_chain.make_inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flux_generator_tpu_torch.scripts.prof_decode_chain import make_inputs

    w, s, x = make_inputs(layers, torch.device("cuda"))
    x = x[:m].contiguous()
    before = dc.launches
    y = dc.decode_chain(w, s, x)
    torch.cuda.synchronize()
    assert dc.launches == before + 1
    ref = dc.decode_chain_plain(w, s, x)
    assert torch.isfinite(y.float()).all()
    assert (y.float() - ref.float()).abs().max().item() <= TOL * ref.float().abs().max().item()
