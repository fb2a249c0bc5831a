"""The bare-dot probe (#13): the plain version against the JAX script's
`_dot_kernel` under `pl.pallas_call(..., interpret=True)` with the script's
BlockSpecs at BM = BN = 256, K 128, 2 steps, on seeded random inputs, and at
the int8 extremes (−128 · −128 over K 256, whose sums reach 2^22; 127
against −127; a zero row of a and a zero column of b, whose scales are
1e-20 / 127); the wrapper's dispatch, argument checks and cluster rule; the
port's probe entry point (`--cpu`, the card-only guard, no jax import); and
the CUDA kernel against the plain version on a card: every mode at shapes
that leave the last persistent round part-empty, at the probe's 64 steps, at
K 32 and 256, with its output laid over freed memory filled with NaN (a tile
the kernel never writes shows), and the int8 modes at the same extremes.

The script (scripts/prof_attn_int8.py) sets jax's compilation-cache
directory when imported; it is loaded by path and the setting is put back.

Tolerances, against the script's kernel and of the kernel against the plain
version on the card: the int8 modes exactly (exact integer sums; the same
scale, amax · f32(1/127), as XLA compiles the script's division by 127; the
same IEEE division x / s, rounding and f32 epilogue order, (s · s_a) · s_b);
"bf16" within one bf16 step (2^-8) of max|out|: f32 sums in another order may
round to the neighbouring bf16 value.

jax is imported inside the tests that use it, so the `cuda` cases run on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_bare_dot.py`."""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import bare_dot as bd

REPO = pathlib.Path(__file__).resolve().parents[1]
BM = BN = 256
K, STEPS = 128, 2


@pytest.fixture(scope="module")
def script():
    import jax

    keys = ("jax_compilation_cache_dir",)
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("prof_attn_int8", REPO / "scripts" / "prof_attn_int8.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _inputs(mode, seed=0, k=K, steps=STEPS, bm=BM, bn=BN):
    rng = np.random.default_rng(seed)
    if mode == "int8":
        return (rng.integers(-127, 128, (steps * bm, k)).astype(np.int8),
                rng.integers(-127, 128, (k, steps * bn)).astype(np.int8))
    return rng.standard_normal((steps * bm, k)).astype(np.float32), rng.standard_normal((k, steps * bn)).astype(
        np.float32)


def _extreme_inputs(case, k=256, steps=STEPS, bm=BM, bn=BN):
    """a, b (f32 holding int8 levels or bf16 values) at the int8 extremes."""
    rng = np.random.default_rng(7)
    if case == "min_times_min":  # every sum −128 · −128 · K: 2^22 at K 256
        return np.full((steps * bm, k), -128, np.float32), np.full((k, steps * bn), -128, np.float32)
    if case == "max_against_min":  # 127 against −127 (even columns) and −128 (odd): the most negative sums
        b = np.full((k, steps * bn), -127, np.float32)
        b[:, 1::2] = -128
        return np.full((steps * bm, k), 127, np.float32), b
    # "zero_row_and_column": bf16 values with a zero row of a and a zero column of b in every step
    a = rng.standard_normal((steps * bm, k)).astype(np.float32)
    b = rng.standard_normal((k, steps * bn)).astype(np.float32)
    a[5::bm] = 0.0
    b[:, 7::bn] = 0.0
    return a, b


EXTREMES = [("int8", "min_times_min"), ("int8", "max_against_min"), ("int8_quant_inside", "zero_row_and_column")]


def _tol(mode, ref):
    return 0.0 if mode != "bf16" else 2.0 ** -8 * float(np.abs(ref).max())


def test_loading_the_script_keeps_jax_settings(script):
    import jax

    assert jax.config.jax_compilation_cache_dir != str(REPO / ".jax_cache")
    assert (script.BM, script.K, script.BN) == (1024, 128, 1024)


@pytest.mark.parametrize("mode", bd.MODES)
def test_plain_version_matches_the_script_kernel(script, mode):
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    a, b = _inputs(mode, seed=1)
    dt = jnp.int8 if mode == "int8" else jnp.bfloat16
    f = pl.pallas_call(
        functools.partial(script._dot_kernel, mode=mode),
        grid=(STEPS,),
        in_specs=[pl.BlockSpec((BM, K), lambda i: (i, 0)), pl.BlockSpec((K, BN), lambda i: (0, i))],
        out_specs=pl.BlockSpec((BM, BN), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((STEPS * BM, BN), jnp.bfloat16),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(a).astype(dt), jnp.asarray(b).astype(dt)).astype(jnp.float32))
    tdt = torch.int8 if mode == "int8" else torch.bfloat16
    at, bt = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = bd.bare_dot(at, bt, mode, bm=BM, bn=BN)
    assert got.dtype == torch.bfloat16 and got.shape == (STEPS * BM, BN)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_tol(mode, want))


@pytest.mark.parametrize("mode,case", EXTREMES)
def test_plain_version_matches_the_script_kernel_at_int8_extremes(script, mode, case):
    """Exact on both sides: integer sums up to 2^22 in f32, and a row or
    column of zeros quantized with the 1e-20 floor of its scale."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    k = 256
    a, b = _extreme_inputs(case, k=k)
    dt = jnp.int8 if mode == "int8" else jnp.bfloat16
    f = pl.pallas_call(
        functools.partial(script._dot_kernel, mode=mode),
        grid=(STEPS,),
        in_specs=[pl.BlockSpec((BM, k), lambda i: (i, 0)), pl.BlockSpec((k, BN), lambda i: (0, i))],
        out_specs=pl.BlockSpec((BM, BN), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((STEPS * BM, BN), jnp.bfloat16),
        interpret=True,
    )
    want = np.asarray(f(jnp.asarray(a).astype(dt), jnp.asarray(b).astype(dt)).astype(jnp.float32))
    tdt = torch.int8 if mode == "int8" else torch.bfloat16
    got = bd.bare_dot(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), mode, bm=BM, bn=BN).float().numpy()
    np.testing.assert_array_equal(got, want)
    if case == "min_times_min":
        assert (got == 2.0 ** 22).all()
    if case == "max_against_min":
        assert set(np.unique(got)) == {float(torch.tensor(-127.0 * c * k).bfloat16()) for c in (127, 128)}
    if case == "zero_row_and_column":
        assert (got[5::BM] == 0).all() and (got[:, 7] == 0).all()


@pytest.mark.parametrize("bn,cluster,times", [(1024, 8, 1), (384, 3, 1), (128, 1, 1), (1280, 5, 2), (1408, 1, 11),
                                              (2048, 8, 2)])
def test_quant_inside_cluster_rule(bn, cluster, times):
    """"int8_quant_inside" runs in clusters of the largest divisor of BN / 128
    up to 8 blocks, one a column tile, and quantizes each a row once for each
    cluster of a step."""
    assert bd.cluster_size(bn) == cluster
    assert bn // bd.TILE // bd.cluster_size(bn) == times


def test_steps_are_block_diagonal():
    """Step i multiplies rows i·BM.. of a by columns i·BN.. of b only."""
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs("bf16", seed=2))
    got = bd.bare_dot_reference(a, b, "bf16", bm=BM, bn=BN).float()
    for i in range(STEPS):
        want = a[i * BM:(i + 1) * BM].float() @ b[:, i * BN:(i + 1) * BN].float()
        torch.testing.assert_close(got[i * BM:(i + 1) * BM], want.to(torch.bfloat16).float(), rtol=0, atol=0)


def test_quant_inside_quantizes_rows_of_a_and_columns_of_b():
    """Hand check of "int8_quant_inside" on one step: x_i = rint(x / s),
    s = max(amax, 1e-20) · f32(1/127) over K, then (dot · s_a) · s_b."""
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs("bf16", seed=3, steps=1))
    af, bf = a.float(), b.float()
    inv = torch.tensor(1 / 127, dtype=torch.float32)
    sa = af.abs().amax(1, keepdim=True) * inv
    sb = bf.abs().amax(0, keepdim=True) * inv
    dots = torch.round(af / sa).double() @ torch.round(bf / sb).double()
    want = (dots.float() * sa * sb).to(torch.bfloat16)
    assert torch.equal(bd.bare_dot_reference(a, b, "int8_quant_inside", bm=BM, bn=BN), want)


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b = (torch.from_numpy(x) for x in _inputs("int8", seed=4))
    before = dict(bd.launches)
    assert torch.equal(bd.bare_dot(a, b, "int8", bm=BM, bn=BN), bd.bare_dot_reference(a, b, "int8", bm=BM, bn=BN))
    assert bd.launches == before


@pytest.mark.parametrize("bad", ["mode", "dtype", "k_not_32", "k_too_big", "bm_not_128", "ragged_steps",
                                 "non_contiguous", "misaligned_bf16", "misaligned_int8"])
def test_kernel_argument_checks_raise(bad):
    a = torch.zeros((2 * 256, 128), dtype=torch.bfloat16)
    b = torch.zeros((128, 2 * 256), dtype=torch.bfloat16)
    mode, bm, bn = "bf16", 256, 256
    if bad == "mode":
        mode = "fp8"
    elif bad == "dtype":
        mode = "int8"
    elif bad == "k_not_32":
        a, b = a[:, :48].contiguous(), b[:48].contiguous()
    elif bad == "k_too_big":
        a, b = torch.zeros((512, 288), dtype=torch.bfloat16), torch.zeros((288, 512), dtype=torch.bfloat16)
    elif bad == "bm_not_128":
        bm, bn = 64, 64
        a, b = a[:128], b[:, :128].contiguous()
    elif bad == "ragged_steps":
        a = a[:300]
    elif bad == "non_contiguous":
        b = torch.zeros((2 * 256, 128), dtype=torch.bfloat16).t()
    elif bad == "misaligned_bf16":  # contiguous, but 2 bytes into its buffer: "bf16" loads with TMA
        a = torch.zeros(2 * 256 * 128 + 8, dtype=torch.bfloat16)[1:1 + 2 * 256 * 128].view(2 * 256, 128)
    elif bad == "misaligned_int8":  # contiguous, but 4 bytes into its buffer: the int8 modes load with TMA too
        mode = "int8"
        a = torch.zeros(2 * 256 * 128 + 16, dtype=torch.int8)[4:4 + 2 * 256 * 128].view(2 * 256, 128)
        b = torch.zeros((128, 2 * 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        bd._check_cuda_args(a, b, mode, bm, bn)
    bd._check_cuda_args(torch.zeros((512, 64), dtype=torch.int8), torch.zeros((64, 512), dtype=torch.int8),
                        "int8", 256, 256)


def test_probe_entry_point_cpu_run_and_card_guard(monkeypatch, capsys):
    from flux_generator_tpu_torch.scripts import prof_attn_int8 as probe

    assert probe.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert all(f"bare dot {mode}" in out for mode in bd.MODES)
    with pytest.raises(RuntimeError, match="card"):
        probe.run(steps=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--steps", "1"])
    q, k, v, cos, sin = probe.flash_inputs(torch.device("cpu"))
    assert q.shape == (1, 16640, 24, 128) and cos.shape == (1, 16640, 64)


def test_probe_entry_point_imports_no_jax():
    code = ("import sys, flux_generator_tpu_torch.scripts.prof_attn_int8\n"
            "loaded = [m for m in sys.modules if m in ('jax', 'flux_generator_tpu') "
            "or m.startswith(('jax.', 'flux_generator_tpu.'))]\n"
            "assert not loaded, loaded")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _on_freed_nan(shape):
    """Leave a freed block of `shape` bf16 filled with NaN in the caching
    allocator, where the next output of that size is likely to lie."""
    torch.empty(shape, dtype=torch.bfloat16, device="cuda").fill_(float("nan"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bd.MODES)
@pytest.mark.parametrize("k,steps,bm,bn", [(128, 2, 1024, 1024), (128, 3, 256, 384), (64, 1, 128, 128),
                                           (256, 2, 256, 256), (96, 2, 256, 128), (32, 3, 128, 256),
                                           (128, 3, 384, 256), (128, 64, 1024, 1024), (128, 67, 128, 1024),
                                           (160, 3, 256, 640), (256, 5, 384, 1152)])
def test_cuda_kernel_matches_plain_version(mode, k, steps, bm, bn):
    """(128, 3, 384, 256): 6 units or 18 tiles, one part-empty round;
    (128, 64, ...): the probe's 512 units, a part-empty fourth round on 132
    blocks, 64 cluster units on 15 clusters of 8; (128, 67, 128, 1024): 536
    units, 67 cluster units; BN 384 and 640 and 1152: clusters of 3, 5 and 3
    blocks, BN 128 and 256 of 1 and 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _inputs(mode, seed=5, k=k, steps=steps, bm=bm, bn=bn)
    tdt = torch.int8 if mode == "int8" else torch.bfloat16
    a, b = torch.from_numpy(a).to("cuda", tdt), torch.from_numpy(b).to("cuda", tdt)
    before = bd.launches[mode]
    _on_freed_nan((steps * bm, bn))
    got = bd.bare_dot(a, b, mode, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert bd.launches[mode] == before + 1
    assert not got.isnan().any()
    ref = bd.bare_dot_reference(a, b, mode, bm=bm, bn=bn).float()
    assert (got.float() - ref).abs().max().item() <= _tol(mode, ref.cpu().numpy())
    if mode != "bf16":
        assert bd.plan(mode, k, bm, bn, steps)["cluster"] == (bd.cluster_size(bn) if mode != "int8" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,case", EXTREMES)
def test_cuda_int8_kernels_exact_at_the_extremes(mode, case):
    """K 256: sums of ±2^22 convert to f32 exactly (the kernel's magic-number
    conversion holds at both ends), and zero rows and columns keep their
    1e-20 / 127 scales; bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = _extreme_inputs(case, k=256, steps=3, bm=256, bn=1024)
    tdt = torch.int8 if mode == "int8" else torch.bfloat16
    a, b = torch.from_numpy(a).to("cuda", tdt), torch.from_numpy(b).to("cuda", tdt)
    _on_freed_nan((3 * 256, 1024))
    got = bd.bare_dot(a, b, mode, bm=256, bn=1024)
    torch.cuda.synchronize()
    assert torch.equal(got, bd.bare_dot_reference(a, b, mode, bm=256, bn=1024))
