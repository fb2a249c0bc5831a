"""The chain-bisect probe (#12): the plain version against the JAX script's
Pallas kernel (scripts/prof_chain_bisect.py, interpret mode) for the eight
cumulative rungs and a ragged dma case, at 2 layers of the script's H 1536
and M 8 on `build`'s own operands (rng 0, ones ln, zero cross K/V and
caches); the ln control; the tanh GELU; the wrapper's dispatch and argument
checks (every shape the kernel refuses); the probe entry point's guards and
imports; and on a card the CUDA kernel (on kernel D's machinery) against the
plain version at every rung and two sets off the ladder (which take the
instantiation that reads the extras at run time), at 48 layers of H 1536 and
at 3 layers of H 512 (a part-filled wave, a ragged dma chunk), at M 1, 2, 5
and 8, with the ln control that must miss; its bits over 50 calls in a row;
and rows of an M-8 call against calls on fewer rows, bit for bit.

The script sets jax's compilation-cache directory and threshold when
imported; it is loaded by path and both settings are put back afterwards.
Its `pl` is wrapped so that every `pallas_call` runs in interpret mode and
keeps its inputs and all its outputs (`build`'s step returns y alone), so
`build` runs unmodified.

Tolerances, of max|y| (and max|kn|, max|vn|): 1e-2, the same bf16-rounded dot
inputs and weights and f32 sums in another order through 2 layers, with bf16
outputs (2^-8 relative); the kernel against the plain version on a card the
same (#11's bound).

jax is imported inside the fixtures that use it, so the `cuda` case runs on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_chain_bisect.py`."""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import chain_bisect as cb
from flux_generator_tpu_torch.ops.kernels.decode_step import CPL

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-2
FULL = cb.RUNGS[-1]
# two sets off the ladder: between them they turn on every extra that changes
# the kernel's code (ln, cross, outs, dma) in the instantiation that reads the
# extras at run time, which any set off the ladder launches
OFF_LADDER = ("ln,outs", "cross,hbm,bufs,dma")


class _InterpretPallas:
    """The script's `pl` with interpret mode on every pallas_call, recording
    the last call's inputs and outputs."""

    def __init__(self, pl):
        self._pl = pl
        self.inputs = self.outputs = None

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        call = self._pl.pallas_call(*args, interpret=True, **kwargs)

        def recorded(*operands):
            self.inputs, self.outputs = operands, call(*operands)
            return self.outputs

        return recorded


@pytest.fixture(scope="module")
def script():
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location("prof_chain_bisect", REPO / "scripts" / "prof_chain_bisect.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = _InterpretPallas(mod.pl)
    return mod


def _torch(a):
    """A jax array as a torch tensor of the same dtype (bf16 through f32)."""
    import jax.numpy as jnp

    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _script_run(script, spec, layers=2, chunk=512, window=512):
    """`build`'s step on its own operands → (the kernel's outputs as f32 numpy,
    the same operands as torch tensors in the wrapper's keywords)."""
    import jax.numpy as jnp

    ex = cb.parse_extras(spec)
    step, x = script.build(ex, layers, chunk, window)
    step(x)
    outs = script.pl.outputs if isinstance(script.pl.outputs, (list, tuple)) else [script.pl.outputs]
    it = iter(script.pl.inputs)
    ops = {}
    if "smem" in ex:
        ops["offset"] = int(np.array(next(it))[0])
    w, s = _torch(next(it)), _torch(next(it))
    if "ln" in ex:
        ops["ln"] = _torch(next(it))
    xt = _torch(next(it))
    if "cross" in ex:
        ops["ck"], ops["cv"] = _torch(next(it)), _torch(next(it))
    if "hbm" in ex:
        ops["kc"], ops["vc"] = _torch(next(it)), _torch(next(it))
    return [np.asarray(o.astype(jnp.float32)) for o in outs], (w, s, xt, ops)


def test_loading_the_script_keeps_jax_settings(script):
    import jax

    assert jax.config.jax_compilation_cache_dir != str(REPO / ".jax_cache")
    assert (script.H, script.CPL, script.M, script.B) == (1536, CPL, 8, cb.B)
    assert tuple(script.LADDER) == cb.LADDER


@pytest.mark.parametrize("spec,chunk,window", [(r, 512, 512) for r in cb.RUNGS] + [(FULL, 128, 320)])
def test_plain_version_matches_the_script_kernel(script, spec, chunk, window):
    """y (and kn, vn with outs) of every cumulative rung; chunk 128 of a
    320-row window leaves a ragged last chunk."""
    want, (w, s, x, ops) = _script_run(script, spec, chunk=chunk, window=window)
    got = cb.chain_bisect(w, s, x, spec, chunk=chunk, **ops)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (3 if "outs" in spec else 1)
    assert got[0].shape == (8, 1536) and all(t.shape == (2, cb.B, 1536) for t in got[1:])
    for g, ref in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_ln_rung_changes_the_output(script):
    """The control: ln's scale and bias move y by more than the tolerance, in
    the script's kernel and in the plain version alike."""
    (y0,), (w, s, x, _) = _script_run(script, "")
    (y1,), (_, _, _, ops) = _script_run(script, "smem,ln")
    assert np.abs(y0 - y1).max() > TOL * np.abs(y1).max()
    plain = cb.chain_bisect(w, s, x, "smem,ln", **ops).float().numpy()
    assert np.abs(cb.chain_bisect(w, s, x, "").float().numpy() - plain).max() > TOL * np.abs(plain).max()


def test_gelu_is_the_scripts_tanh_form():
    import jax.numpy as jnp

    g = np.linspace(-6, 6, 2001, dtype=np.float32)
    gj = jnp.asarray(g)
    want = np.asarray(0.5 * gj * (1.0 + jnp.tanh(0.7978845608 * (gj + 0.044715 * gj ** 3))))
    got = cb.gelu_tanh(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(g), approximate="none").numpy()
    assert np.abs(got - exact).max() > 1e-4  # not #11's erf


def _small(m=8, h=256, layers=1, window=20, seed=3):
    rng = np.random.default_rng(seed)
    n = layers * CPL
    w = torch.from_numpy(rng.integers(-127, 128, size=(n, h, h), dtype=np.int8))
    s = torch.from_numpy((0.5 + rng.random((n, 1, h), dtype=np.float32)) / (127 * h ** 0.5)).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(m, h)).astype(np.float32)).to(torch.bfloat16)

    def bf(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)

    ops = dict(offset=3, ln=bf(layers, 8, h), ck=bf(layers, cb.B, 12, h), cv=bf(layers, cb.B, 12, h),
               kc=bf(layers, cb.B, window, h), vc=bf(layers, cb.B, window, h))
    return w, s, x, ops


@pytest.mark.parametrize("operand,extra", [("ck", "cross"), ("kc", "dma")])
def test_zero_terms_carry_nan(operand, extra):
    """The 0· terms are kept: a NaN in row 0 of a cross K (cross) or in the
    touched cache row (dma) reaches y, as in the script's kernel."""
    w, s, x, ops = _small()
    spec = "smem,ln,cross" if extra == "cross" else FULL
    ops = {k: v for k, v in ops.items() if cb.OPERAND_EXTRA[k] in cb.parse_extras(spec)}

    def y():
        out = cb.chain_bisect(w, s, x, spec, chunk=8, **ops)
        return (out[0] if isinstance(out, tuple) else out).float()

    assert torch.isfinite(y()).all()
    row = 0 if extra == "cross" else cb.touched_row(ops["kc"].shape[2], 8)
    ops[operand] = ops[operand].clone()
    ops[operand][0, 0, row, 5] = float("nan")
    assert torch.isnan(y()).any()


def test_touched_row_follows_the_script():
    # the last chunk loaded into slot 0: chunk j even, j ≤ n_chunks - 1
    assert [cb.touched_row(w, c) for w, c in ((512, 512), (320, 128), (1024, 128), (100, 30))] == [0, 256, 768, 60]


def test_cpu_tensors_take_the_plain_version_without_counting():
    w, s, x, ops = _small(seed=4)
    before = cb.launches
    got = cb.chain_bisect(w, s, x, FULL, chunk=8, **ops)
    want = cb.chain_bisect_plain(w, s, x, FULL, chunk=8, **ops)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cb.launches == before


@pytest.mark.parametrize("bad", ["dma_alone", "dma_no_bufs", "unknown", "missing_ln", "missing_kc", "extra_operand",
                                 "f32_x", "bf16_w", "f32_ln", "ln_shape", "ck_batch", "kc_h", "rows_9", "h_384",
                                 "outs_one_row", "offset_float", "chunk_0", "rows_0", "h_8448"])
def test_wrapper_raises(bad):
    w, s, x, ops = _small()
    spec = FULL
    if bad == "dma_alone":
        spec, ops = "dma", {}
    elif bad == "dma_no_bufs":
        spec = "smem,ln,cross,hbm,outs,dma"
    elif bad == "unknown":
        spec = "smem,vmem"
    elif bad == "missing_ln":
        ops.pop("ln")
    elif bad == "missing_kc":
        ops.pop("kc")
    elif bad == "extra_operand":
        spec = "smem,ln"
    elif bad == "f32_x":
        x = x.float()
    elif bad == "bf16_w":
        w = w.to(torch.bfloat16)
    elif bad == "f32_ln":
        ops["ln"] = ops["ln"].float()
    elif bad == "ln_shape":
        ops["ln"] = ops["ln"][:, :2]
    elif bad == "ck_batch":
        ops["ck"] = torch.cat([ops["ck"], ops["ck"]], 1)
    elif bad == "kc_h":
        ops["kc"] = ops["kc"][..., :128].contiguous()
    elif bad == "rows_9":
        x = torch.zeros((9, x.shape[1]), dtype=torch.bfloat16)
    elif bad == "h_384":
        w, s, x = torch.zeros((CPL, 384, 384), dtype=torch.int8), torch.ones((CPL, 1, 384), dtype=torch.bfloat16), \
            torch.zeros((8, 384), dtype=torch.bfloat16)
    elif bad == "outs_one_row":
        x = x[:1].contiguous()
    elif bad == "offset_float":
        ops["offset"] = 3.0
    elif bad == "chunk_0":
        ops["chunk"] = 0
    elif bad == "rows_0":
        x = x[:0]
    elif bad == "h_8448":  # shapes only: meta tensors hold no data
        w, s, x = torch.empty((CPL, 8448, 8448), dtype=torch.int8, device="meta"), \
            torch.empty((CPL, 1, 8448), dtype=torch.bfloat16, device="meta"), \
            torch.empty((8, 8448), dtype=torch.bfloat16, device="meta")
        spec, ops = "", {}
    with pytest.raises(ValueError):
        cb.chain_bisect(w, s, x, spec, **ops)


@pytest.mark.parametrize("bad", ["strided_x", "misaligned_w", "misaligned_s", "misaligned_ln", "misaligned_kc",
                                 "misaligned_vc"])
def test_kernel_operand_checks_raise(bad):
    """What the kernel takes beyond the contract: contiguous operands, and w
    (its TMA map), s, ln and the caches (16-byte loads) 16-byte aligned."""
    w, s, x, ops = _small()
    ops.pop("offset")

    def shifted(t):  # the same values one element past a 16-byte boundary
        flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    cb._check_kernel_operands(w, s, x, dict(ops, offset=3))
    if bad == "strided_x":
        x = torch.cat([x, x], 1)[:, ::2]
    elif bad == "misaligned_w":
        w = shifted(w)
    elif bad == "misaligned_s":
        s = shifted(s)
    else:
        ops[bad[11:]] = shifted(ops[bad[11:]])
    with pytest.raises(ValueError):
        cb._check_kernel_operands(w, s, x, dict(ops, offset=3))


def test_extras_parse_as_the_script_does():
    assert cb.parse_extras("smem,,ln") == {"smem", "ln"} == cb.parse_extras(["ln", "smem"])
    assert cb.extras_mask(FULL) == 127 and cb.extras_mask("") == 0 and cb.extras_mask("ln,cross") == 6
    assert cb.RUNGS[0] == "" and cb.RUNGS[3] == cb.LADDER[-1] and len(cb.RUNGS) == 8


def test_off_ladder_sets_take_the_run_time_instantiation():
    """The kernel picks an instantiation by the extras that change its code
    (ln, cross, outs, dma; chain_bisect.cu's `bisect_kernel`): each rung's
    own, and for any other set the one that reads the extras at run time.
    The `cuda` cases' two sets off the ladder mask to no rung's set, and
    together turn on all four."""
    code = sum(1 << cb.EXTRAS.index(e) for e in ("ln", "cross", "outs", "dma"))
    rungs = {cb.extras_mask(r) & code for r in cb.RUNGS}
    assert {cb.extras_mask(s) & code for s in OFF_LADDER}.isdisjoint(rungs)
    assert cb.extras_mask(",".join(OFF_LADDER)) & code == code
    src = (REPO / "flux_generator_tpu_torch" / "csrc" / "decode_probe.cuh").read_text()
    assert "X_CODE = X_LN | X_CROSS | X_OUTS | X_DMA;" in src


def test_probe_entry_point_runs_on_the_card_only(monkeypatch):
    from flux_generator_tpu_torch.scripts import prof_chain_bisect as probe

    with pytest.raises(RuntimeError, match="card"):
        probe.run(layers=1, steps=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--ladder", "--layers", "1", "--steps", "1"])
    ops = probe.make_extra_operands(FULL, 1, 40, torch.device("cpu"))
    assert set(ops) == set(cb.OPERAND_EXTRA) and ops["kc"].shape == (1, cb.B, 40, 1536)
    assert all(torch.isfinite(t.float()).all() for k, t in ops.items() if k != "offset")
    # the bytes of the full rung: #11's, the ln rows, cross rows, kn/vn and the caches
    base = probe.step_bytes("", 48, 8, 512)
    assert base == 48 * CPL * 1536 * (1536 + 2) + 4 * 8 * 1536
    assert probe.step_bytes(FULL, 48, 8, 512) - base == 48 * 1536 * (4 + 4 * cb.B + 4 * cb.B + 4 * cb.B * 512)


def test_probe_and_wrapper_import_no_jax():
    code = ("import sys, flux_generator_tpu_torch.scripts.prof_chain_bisect, "
            "flux_generator_tpu_torch.ops.kernels.chain_bisect\n"
            "loaded = [m for m in sys.modules if m in ('jax', 'flux_generator_tpu') "
            "or m.startswith(('jax.', 'flux_generator_tpu.'))]\n"
            "assert not loaded, loaded")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cuda_case(layers, h, window, seed=0):
    """Unit-scale weights (as prof_decode_chain.make_inputs), 8 rows and
    every extra's operands (prof_chain_bisect.make_extra_operands' draws),
    at width h, on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n = layers * CPL
    w = torch.randint(-127, 128, (n, h, h), generator=g, device=dev, dtype=torch.int8)
    s = ((0.5 + torch.rand((n, 1, h), generator=g, device=dev)) / (127 * h ** 0.5)).to(torch.bfloat16)
    x = torch.randn((8, h), generator=g, device=dev).to(torch.bfloat16)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    ln = torch.stack([1 + 0.1 * torch.randn((layers, h), generator=g, device=dev),
                      0.1 * torch.randn((layers, h), generator=g, device=dev)], dim=1).repeat(1, 4, 1)
    ops = dict(offset=window // 2, ln=ln.to(torch.bfloat16).contiguous(), ck=randn(layers, cb.B, 12, h),
               cv=randn(layers, cb.B, 12, h), kc=randn(layers, cb.B, window, h), vc=randn(layers, cb.B, window, h))
    return w, s, x, ops


def _pick(ops, spec):
    ex = cb.parse_extras(spec)
    return {k: v for k, v in ops.items() if cb.OPERAND_EXTRA[k] in ex}


# (layers, H, window, chunk): the probe's shape, and a small one whose phases
# fill a part of one wave and whose dma chunk is ragged
CUDA_SHAPES = [(48, 1536, 512, 512), (3, 512, 300, 128)]
CUDA_SPECS = cb.RUNGS + OFF_LADDER


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=lambda v: f"L{v[0]}_H{v[1]}")
@pytest.mark.parametrize("spec,m", [(r, m) for r in CUDA_SPECS for m in (8, 5, 2, 1) if m >= 2 or "outs" not in r])
def test_cuda_kernel_matches_plain_version(spec, m, shape):
    """Every rung and the two sets off the ladder against the plain version
    on the card; M 5 leaves the middle thread group of the rows partly
    filled."""
    _card()
    from flux_generator_tpu_torch.scripts.prof_chain_bisect import rel_errors

    layers, h, window, chunk = shape
    w, s, x, ops = _cuda_case(layers, h, window)
    x = x[:m].contiguous()
    ops = _pick(ops, spec)
    before = cb.launches
    got = cb.chain_bisect(w, s, x, spec, chunk=chunk, **ops)
    torch.cuda.synchronize()
    assert cb.launches == before + 1
    ref = cb.chain_bisect_plain(w, s, x, spec, chunk=chunk, **ops)
    assert all(torch.isfinite(t.float()).all() for t in (got if isinstance(got, tuple) else (got,)))
    assert max(rel_errors(got, ref).values()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=lambda v: f"L{v[0]}_H{v[1]}")
def test_cuda_ln_control_misses(shape):
    """The control: the no-extras kernel against the ln rung's plain version
    must miss the tolerance that the ln rung's kernel meets."""
    _card()
    from flux_generator_tpu_torch.scripts.prof_chain_bisect import rel_errors

    layers, h, window, chunk = shape
    w, s, x, ops = _cuda_case(layers, h, window, seed=1)
    ref = cb.chain_bisect_plain(w, s, x, "smem,ln", **_pick(ops, "smem,ln"))
    assert rel_errors(cb.chain_bisect(w, s, x, "smem,ln", **_pick(ops, "smem,ln")), ref)["y"] <= TOL
    assert rel_errors(cb.chain_bisect(w, s, x, ""), ref)["y"] > TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=lambda v: f"L{v[0]}_H{v[1]}")
@pytest.mark.parametrize("spec", [FULL, "ln,cross,hbm,bufs,dma"])
def test_cuda_kernel_bits_repeat_over_50_steps(spec, shape):
    """50 calls in a row give the bits of the first (y, and kn, vn with
    outs): the fold tickets and the ring's phases start over every step."""
    _card()
    layers, h, window, chunk = shape
    w, s, x, ops = _cuda_case(layers, h, window, seed=2)
    ops = _pick(ops, spec)

    def bits():
        out = cb.chain_bisect(w, s, x, spec, chunk=chunk, **ops)
        return [t.view(torch.int16) for t in (out if isinstance(out, tuple) else (out,))]

    first = bits()
    again = [bits() for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for later in again for a, b in zip(first, later))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=lambda v: f"L{v[0]}_H{v[1]}")
def test_cuda_kernel_rows_do_not_depend_on_m(shape):
    """Row r of an M-8 call equals an M-1 call on row r, bit for bit (every
    extra but outs, which writes rows 0 and 1); with every extra, rows 0-1
    of y, kn and vn equal an M-2 call's."""
    _card()
    layers, h, window, chunk = shape
    w, s, x, ops = _cuda_case(layers, h, window, seed=3)
    spec = "smem,ln,cross,hbm,bufs,dma"
    y8 = cb.chain_bisect(w, s, x, spec, chunk=chunk, **_pick(ops, spec))
    for r in range(8):
        y1 = cb.chain_bisect(w, s, x[r:r + 1].contiguous(), spec, chunk=chunk, **_pick(ops, spec))
        assert torch.equal(y8[r:r + 1].view(torch.int16), y1.view(torch.int16)), r
    full8 = cb.chain_bisect(w, s, x, FULL, chunk=chunk, **_pick(ops, FULL))
    full2 = cb.chain_bisect(w, s, x[:2].contiguous(), FULL, chunk=chunk, **_pick(ops, FULL))
    assert torch.equal(full8[0][:2].view(torch.int16), full2[0].view(torch.int16))
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(full8[1:], full2[1:]))
