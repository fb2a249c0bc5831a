"""The decode-chain probe (#11): the plain chain against the JAX script's
`jnp_chain` and its Pallas kernel `pallas_chain` (interpret mode) at 2
layers of the script's H 1536 and M 8, the wrapper's dispatch and argument
checks (every shape the kernel refuses), the probe entry point's guards,
and on a card the CUDA kernel (on kernel D's machinery) against the plain
chain at 48 layers of H 1536 and at 3 layers of H 512 (whose phases fill a
part of one wave of the grid), at M 1, 2, 5 and 8, with a control that must
miss; its bits over 50 calls in a row; and each row of an M-8 call against
an M-1 call on that row, bit for bit.

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


@pytest.mark.parametrize("bad", ["f32_x", "bf16_w", "rows_9", "rows_0", "h_384", "h_128", "h_8448", "w_layers",
                                 "s_shape", "strided_x", "misaligned_w", "misaligned_s"])
def test_kernel_argument_checks_raise(bad):
    """Every shape the kernel refuses: types, 1..8 rows, H a multiple of its
    256-row weight tiles up to 8192, (L·14, H, H) weights, contiguous
    operands, w and s 16-byte aligned (its TMA map, the scales' 16-byte
    copies)."""
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
    elif bad == "rows_0":
        x = torch.zeros((0, h), dtype=torch.bfloat16)
    elif bad in ("h_128", "h_8448"):
        hb = int(bad[2:])  # shapes only: meta tensors hold no data
        w, s, x = torch.empty((n, hb, hb), dtype=torch.int8, device="meta"), \
            torch.empty((n, 1, hb), dtype=torch.bfloat16, device="meta"), \
            torch.empty((m, hb), dtype=torch.bfloat16, device="meta")
    elif bad == "misaligned_w":
        w = torch.zeros(n * h * h + 1, dtype=torch.int8)[1:].view(n, h, h)
    elif bad == "misaligned_s":
        s = torch.ones(n * h + 1, dtype=torch.bfloat16)[1:].view(n, 1, h)
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


# sha256 of csrc/decode_step.cu (kernel D). csrc/decode_probe.cuh carries a
# copy of D's phase code (stage_inputs, projection, fold_sum, the kernel's
# ring start, the cache loads of attend_pass and self_attention) for the
# probes; what D and the probes share (the schedule, the weight ring, the
# products, the tickets, the grid sync, the row splits) is in
# csrc/decode_ring.cuh and follows by itself.
D_SOURCE_SHA256 = "4a894d081ef72e8a016dc6b6e5758ef0c212d93670dc4d00fee3a87b2751dd35"


def test_probe_copy_follows_kernel_d():
    """A change to D's source fails here until decode_probe.cuh's copy of
    D's phase code is brought up to date with it (or found not to be
    affected) and D_SOURCE_SHA256 is moved: otherwise #11 and #12 would go
    on measuring the old D."""
    import hashlib

    src = (REPO / "flux_generator_tpu_torch" / "csrc" / "decode_step.cu").read_bytes()
    assert hashlib.sha256(src).hexdigest() == D_SOURCE_SHA256, (
        "decode_step.cu changed: carry the change into decode_probe.cuh's copy of D's phase code "
        "(or check that it does not apply), then update D_SOURCE_SHA256")


def _cuda_inputs(layers, h, seed=0):
    """Unit-scale weights (|w·s| ~ 0.6/√H, as prof_decode_chain.make_inputs)
    and 8 rows, drawn on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n = layers * CPL
    w = torch.randint(-127, 128, (n, h, h), generator=g, device=dev, dtype=torch.int8)
    s = ((0.5 + torch.rand((n, 1, h), generator=g, device=dev)) / (127 * h ** 0.5)).to(torch.bfloat16)
    x = torch.randn((8, h), generator=g, device=dev).to(torch.bfloat16)
    return w, s, x


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_comparison_entry_point_needs_the_card(monkeypatch):
    """prof_decode_step times D and the probes on the card only, and its
    D shapes are kernels-musicgen's and kernels-musicgen-f8's."""
    from flux_generator_tpu_torch.scripts import prof_decode_step as cmp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cmp.main(["--root", str(REPO)])
    assert len(cmp.D_CASES) == 9 and {c[5] for c in cmp.D_CASES} == {"bf16", "e4m3"}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("layers,h", [(48, 1536), (3, 512)])
def test_cuda_kernel_matches_plain_version(layers, h, m):
    """The kernel against the plain chain on the card (M 5 leaves the
    middle thread group of the rows partly filled); the control, the plain
    chain without its last layer, must miss the same tolerance."""
    _card()
    w, s, x = _cuda_inputs(layers, h)
    x = x[:m].contiguous()
    before = dc.launches
    y = dc.decode_chain(w, s, x)
    torch.cuda.synchronize()
    assert dc.launches == before + 1
    ref = dc.decode_chain_plain(w, s, x).float()
    short = dc.decode_chain_plain(w[:-CPL], s[:-CPL], x).float()
    assert torch.isfinite(y.float()).all()
    scale = ref.abs().max().item()
    assert (y.float() - ref).abs().max().item() <= TOL * scale
    assert (y.float() - short).abs().max().item() > TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("layers,h", [(48, 1536), (3, 512)])
def test_cuda_kernel_bits_repeat_over_50_steps(layers, h):
    """50 calls in a row give the bits of the first: the fold tickets and
    the ring's phases start over at every step."""
    _card()
    w, s, x = _cuda_inputs(layers, h, seed=1)
    first = dc.decode_chain(w, s, x)
    again = [dc.decode_chain(w, s, x) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(first.view(torch.int16), y.view(torch.int16)) for y in again)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,h", [(48, 1536), (3, 512)])
def test_cuda_kernel_rows_do_not_depend_on_m(layers, h):
    """Row r of an M-8 call equals an M-1 call on row r, bit for bit."""
    _card()
    w, s, x = _cuda_inputs(layers, h, seed=2)
    y8 = dc.decode_chain(w, s, x)
    for r in range(8):
        y1 = dc.decode_chain(w, s, x[r:r + 1].contiguous())
        assert torch.equal(y8[r:r + 1].view(torch.int16), y1.view(torch.int16)), r


@pytest.mark.cuda
def test_cuda_phase_times_cover_six_phases():
    """One stamped launch splits a step into the six phases a layer, each
    positive, and gives the bits of an unstamped one."""
    _card()
    w, s, x = _cuda_inputs(3, 512, seed=3)
    y = dc.decode_chain(w, s, x)
    split = dc.phase_times(w, s, x)
    assert tuple(split) == dc.PHASE_NAMES and all(v > 0 for v in split.values())
    assert torch.equal(y.view(torch.int16), dc.decode_chain(w, s, x).view(torch.int16))
    assert dc.kernel_info()["syncs_per_layer"] == dc.SYNCS_PER_LAYER == 6
