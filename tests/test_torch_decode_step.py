"""The fused MusicGen decode step: the port's packer against the JAX packer,
its plain version against the JAX Pallas kernels v2, v1 and v3 (interpret
mode on CPU), and the CUDA kernel (kernel D) against the plain version on a
card.

Tolerances. Plain version against JAX: max|Δy| ≤ 2e-2 · max|y| and the new
cache rows within 2e-2 · max|row| — both sides round dot inputs and weights
to bf16, but the TPU kernel also rounds each q·k product, P·V product and
the softmax denominators to bf16 (its head sums run through bf16 MXU dots),
which the port keeps in f32; y is bf16 (2^-8 relative). Kernel against the
plain version on a card: the same arithmetic in another summation order,
max|Δ| ≤ 1e-2 · max|y|; rows independent of B and launches reproducible,
bit for bit.

jax is imported inside the tests that use it, so the `cuda` case runs on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_decode_step.py`."""

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import decode_step as ds

H, HEADS, FFN, LAYERS, S_TEXT = 32, 4, 128, 2, 6
Y_TOL = 2e-2
ROW_TOL = 2e-2


def _t(a):
    from flux_generator_tpu_torch.io.params import to_torch

    return to_torch(np.asarray(a))


def _setup(quantize: bool, b: int, w: int, offset: int, cond_len):
    """JAX params (bf16), packed both ways, and inputs made with numpy."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu.ops.pallas.decode_layer import pack_decode_weights as jax_pack
    from flux_generator_tpu.ops.quant import quantize_tree

    cfg = jmg.tiny_musicgen_config(hidden_size=H, num_attention_heads=HEADS, ffn_dim=FFN,
                                   num_hidden_layers=LAYERS)
    params = jmg.init_musicgen(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    if quantize:
        params = dict(params, layers=quantize_tree(params["layers"], predicate=lambda p: True))
    rng = np.random.default_rng(1)
    cond = jnp.asarray((rng.standard_normal((b, S_TEXT, H)) * 0.3).astype(np.float32), jnp.bfloat16)
    ck, cv = (a.reshape(LAYERS, b, S_TEXT, H) for a in jmg.precompute_cross_kv(params, cfg, cond))
    x = jnp.asarray(rng.standard_normal((b, H)).astype(np.float32), jnp.bfloat16)
    kc = np.zeros((LAYERS, b, w, H), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :offset] = rng.standard_normal((LAYERS, b, offset, H)) * 0.5
    vc[:, :, :offset] = rng.standard_normal((LAYERS, b, offset, H)) * 0.5
    kc, vc = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
    cl = None if cond_len is None else jnp.asarray(cond_len, jnp.int32)
    jax_packed = jax_pack(params["layers"], H, FFN)
    from flux_generator_tpu_torch.io.params import to_torch

    layers_t = to_torch(jax.tree.map(np.asarray, params["layers"]))
    return dict(params=params, layers_t=layers_t, jax_packed=jax_packed, x=x, ck=ck, cv=cv, kc=kc,
                vc=vc, cl=cl, offset=offset)


def _run_both(s, impl: str):
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas import decode_layer as jdl

    fn = {"v1": jdl.fused_decode_step, "v2": jdl.fused_decode_step2, "v3": jdl.fused_decode_step3}[impl]
    kw = {"chunk": 8} if impl in ("v1", "v3") else {}  # several window chunks on the JAX side
    jy, jkc, jvc = fn(s["jax_packed"], s["x"], s["ck"], s["cv"], jnp.int32(s["offset"]), s["kc"],
                      s["vc"], s["cl"], n_heads=HEADS, interpret=True, **kw)
    packed = ds.pack_decode_weights(s["layers_t"], H, FFN)
    cl = None if s["cl"] is None else _t(s["cl"])
    ty, tkc, tvc = ds.fused_decode_step(packed, _t(s["x"]), _t(s["ck"]), _t(s["cv"]), s["offset"],
                                        _t(s["kc"]), _t(s["vc"]), cl, n_heads=HEADS)
    return (np.asarray(jy, np.float32), np.asarray(jkc, np.float32), np.asarray(jvc, np.float32),
            ty.float().numpy(), tkc.float().numpy(), tvc.float().numpy())


def _check(out, offset):
    jy, jkc, jvc, ty, tkc, tvc = out
    assert np.isfinite(ty).all()
    assert np.abs(ty - jy).max() <= Y_TOL * np.abs(jy).max(), np.abs(ty - jy).max()
    for j, t in ((jkc, tkc), (jvc, tvc)):
        row_j, row_t = j[:, :, offset], t[:, :, offset]
        assert np.abs(row_t - row_j).max() <= ROW_TOL * np.abs(row_j).max()
        # every other row is left as it was
        np.testing.assert_array_equal(np.delete(t, offset, axis=2), np.delete(j, offset, axis=2))


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
def test_plain_version_matches_jax_v2(quantize):
    s = _setup(quantize, b=2, w=16, offset=9, cond_len=[4, 6])
    _check(_run_both(s, "v2"), 9)


@pytest.mark.parametrize("impl,b,w,offset", [("v1", 4, 24, 17), ("v3", 2, 24, 20)])
def test_plain_version_matches_jax_v1_v3(impl, b, w, offset):
    """v1 (manual chunk DMA) and v3 (streamed chunks), each against its own
    JAX function, with an 8-row chunk so the window spans several chunks."""
    s = _setup(True, b=b, w=w, offset=offset, cond_len=[3, 6, 1, 5][:b])
    _check(_run_both(s, impl), offset)


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
def test_packer_matches_jax_packer(quantize):
    s = _setup(quantize, b=2, w=8, offset=0, cond_len=None)
    got = ds.pack_decode_weights(s["layers_t"], H, FFN)
    for key in ("w", "s", "ln"):
        want = _t(s["jax_packed"][key])
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        assert torch.equal(got[key], want), key
    assert ds.packable(s["layers_t"])


def test_packable_rejects_grouped_and_int4():
    from flux_generator_tpu_torch.models.musicgen.model import init_musicgen, tiny_musicgen_config
    from flux_generator_tpu_torch.ops.quant import quantize_tree

    cfg = tiny_musicgen_config(ffn_dim=128)
    layers = init_musicgen(torch.Generator().manual_seed(0), cfg)["layers"]
    assert ds.packable(layers)
    assert ds.packable(quantize_tree(layers, lambda p: True))
    assert not ds.packable(quantize_tree(layers, lambda p: True, group_size=16))
    assert not ds.packable(quantize_tree(layers, lambda p: True, bits=4, pack=True))


def test_offset_zero_attends_to_the_token_alone():
    """At offset 0 the cache holds nothing live: garbage rows must not leak."""
    from flux_generator_tpu_torch.models.musicgen.model import init_musicgen, tiny_musicgen_config

    cfg = tiny_musicgen_config(ffn_dim=128)
    g = torch.Generator().manual_seed(3)
    packed = ds.pack_decode_weights(init_musicgen(g, cfg)["layers"], cfg.hidden_size, cfg.ffn_dim)
    x = torch.randn(2, cfg.hidden_size, generator=g)
    ck = torch.randn(cfg.num_hidden_layers, 2, 3, cfg.hidden_size, generator=g)
    clean = torch.zeros(cfg.num_hidden_layers, 2, 4, cfg.hidden_size)
    dirty = clean.clone()
    dirty[:, :, 1:] = float("nan")
    y0, _, _ = ds.fused_decode_step(packed, x, ck, ck, 0, clean.clone(), clean.clone(), n_heads=4)
    y1, _, _ = ds.fused_decode_step(packed, x, ck, ck, 0, dirty.clone(), dirty.clone(), n_heads=4)
    assert torch.equal(y0, y1)


def test_cpu_tensors_take_the_plain_version_without_counting():
    from flux_generator_tpu_torch.models.musicgen.model import init_musicgen, tiny_musicgen_config

    cfg = tiny_musicgen_config(ffn_dim=128)
    g = torch.Generator().manual_seed(4)
    packed = ds.pack_decode_weights(init_musicgen(g, cfg)["layers"], cfg.hidden_size, cfg.ffn_dim)
    x = torch.randn(2, cfg.hidden_size, generator=g)
    ck = torch.randn(cfg.num_hidden_layers, 2, 3, cfg.hidden_size, generator=g)
    kc = torch.zeros(cfg.num_hidden_layers, 2, 4, cfg.hidden_size)
    before = ds.launches
    got = ds.fused_decode_step(packed, x, ck, ck, 2, kc.clone(), kc.clone(), n_heads=4)[0]
    want = ds.fused_decode_step_plain(packed, x, ck, ck, 2, kc.clone(), kc.clone(), n_heads=4)[0]
    assert torch.equal(got, want)
    assert ds.launches == before


def _kernel_inputs(b=2, h=256, heads=4, n_layers=2, s_text=5, w=16, dtype=torch.bfloat16,
                   w_dtype=torch.int8, device="cpu"):
    g = torch.Generator().manual_seed(11)
    n = n_layers * ds.CPL
    if w_dtype == torch.int8:  # unit-scale outputs: |w·s| ~ 0.6 / √h
        wt = torch.randint(-127, 128, (n, h, h), generator=g, dtype=torch.int8)
        sc = (0.5 + torch.rand(n, 1, h, generator=g)) / (127 * h ** 0.5)
    else:
        wt = (torch.randn(n, h, h, generator=g) / h ** 0.5).to(w_dtype)
        sc = torch.ones(n, 1, h)
    packed = {"w": wt, "s": sc.to(torch.bfloat16),
              "ln": torch.rand(n_layers, 8, h, generator=g).to(torch.bfloat16)}
    packed = {k: v.to(device) for k, v in packed.items()}
    x = torch.randn(b, h, generator=g).to(dtype).to(device)
    ck = torch.randn(n_layers, b, s_text, h, generator=g).to(dtype).to(device)
    kc = torch.randn(n_layers, b, w, h, generator=g).to(dtype).to(device)
    cl = torch.full((b,), s_text, dtype=torch.int32, device=device)
    return packed, x, ck, kc, cl, heads


@pytest.mark.parametrize("bad", ["f32_weights", "f32_x", "batch_9", "head_dim_32", "h_not_256",
                                 "h_past_8192", "offset_past_window", "cond_len_int64", "cache_shape"])
def test_kernel_argument_checks_raise(bad):
    kw = {}
    if bad == "batch_9":
        kw["b"] = 9
    elif bad == "head_dim_32":
        kw["heads"] = 8
    elif bad == "h_not_256":
        kw.update(h=384, heads=6)
    packed, x, ck, kc, cl, heads = _kernel_inputs(**kw)
    offset = 3
    vc = kc
    if bad == "f32_weights":
        packed["w"] = packed["w"].float()
    elif bad == "f32_x":
        x = x.float()
    elif bad == "offset_past_window":
        offset = kc.shape[2]
    elif bad == "cond_len_int64":
        cl = cl.long()
    elif bad == "cache_shape":
        vc = kc[:, :, :-1].contiguous()
    elif bad == "h_past_8192":  # the weights as a broadcast view: 1 GB would be real
        h, heads = 8448, 132
        packed = {"w": torch.zeros((), dtype=torch.int8).expand(ds.CPL, h, h),
                  "s": torch.ones(ds.CPL, 1, h, dtype=torch.bfloat16),
                  "ln": torch.ones(1, 8, h, dtype=torch.bfloat16)}
        x = torch.zeros(2, h, dtype=torch.bfloat16)
        ck = torch.zeros(1, 2, 5, h, dtype=torch.bfloat16)
        kc = vc = torch.zeros(1, 2, 16, h, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ds._check_cuda_args(packed, x, ck, ck, offset, kc, vc, cl, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("b,w,offset,masked", [(2, 8, 5, False), (2, 40, 33, True), (8, 300, 257, True)])
def test_cuda_kernel_matches_plain_version(w_dtype, b, w, offset, masked):
    """Kernel D against the plain version on the same bf16 inputs (H 256, 4
    heads of 64, 2 layers); masked cases give some rows a short cond_len."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed, x, ck, kc, cl, heads = _kernel_inputs(b=b, w=w, w_dtype=w_dtype, device="cuda")
    if masked:
        cl[::2] = 2
    vc = kc.flip(2).contiguous()
    before = ds.launches
    y, k1, v1 = ds.fused_decode_step(packed, x, ck, ck, offset, kc.clone(), vc.clone(), cl,
                                     n_heads=heads)
    torch.cuda.synchronize()
    assert ds.launches == before + 1
    ref, k2, v2 = ds.fused_decode_step_plain(packed, x, ck, ck, offset, kc.clone(), vc.clone(), cl,
                                             n_heads=heads)
    scale = ref.float().abs().max().item()
    assert (y.float() - ref.float()).abs().max().item() <= 1e-2 * scale
    for got, want in ((k1, k2), (v1, v2)):
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_cuda_kernel_matches_plain_version_at_musicgen_width(w_dtype):
    """Kernel D against the plain version at MusicGen-medium's width (H 1536,
    24 heads of 64), 2 layers, B 2, a 300-row window at offset 257, one row's
    text masked: the tolerance of the H 256 cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed, x, ck, kc, cl, heads = _kernel_inputs(b=2, h=1536, heads=24, w=300, w_dtype=w_dtype, device="cuda")
    cl[1] = 2
    vc = kc.flip(2).contiguous()
    y, k1, v1 = ds.fused_decode_step(packed, x, ck, ck, 257, kc.clone(), vc.clone(), cl, n_heads=heads)
    ref, k2, v2 = ds.fused_decode_step_plain(packed, x, ck, ck, 257, kc.clone(), vc.clone(), cl, n_heads=heads)
    torch.cuda.synchronize()
    assert (y.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    for got, want, orig in ((k1, k2, kc), (v1, v2, vc)):
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()
        # every other row is left as it was
        assert torch.equal(torch.cat([got[:, :, :257], got[:, :, 258:]], 2),
                           torch.cat([orig[:, :, :257], orig[:, :, 258:]], 2))


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_cuda_rows_do_not_depend_on_the_batch(w_dtype):
    """Every split of D's sums is chosen from the width and the offset, never
    from B: rows 0–1 of a B 8 launch equal, bit for bit, a B 2 launch on the
    same two rows (y and the new cache rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed, x, ck, kc, cl, heads = _kernel_inputs(b=8, w=300, w_dtype=w_dtype, device="cuda")
    cl[1::2] = 2
    vc = kc.flip(2).contiguous()
    y8, k8, v8 = ds.fused_decode_step(packed, x, ck, ck, 257, kc.clone(), vc.clone(), cl, n_heads=heads)
    two = [t[:, :2].contiguous() for t in (ck, kc, vc)]
    y2, k2, v2 = ds.fused_decode_step(packed, x[:2].contiguous(), two[0], two[0], 257, two[1], two[2],
                                      cl[:2].contiguous(), n_heads=heads)
    torch.cuda.synchronize()
    assert torch.equal(y8[:2].view(torch.int16), y2.view(torch.int16))
    assert torch.equal(k8[:, :2].view(torch.int16), k2.view(torch.int16))
    assert torch.equal(v8[:, :2].view(torch.int16), v2.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_cuda_launches_are_reproducible(w_dtype):
    """Every sum has one fixed order: two launches on the same inputs give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    packed, x, ck, kc, cl, heads = _kernel_inputs(b=4, w=600, w_dtype=w_dtype, device="cuda")
    vc = kc.flip(2).contiguous()
    outs = [ds.fused_decode_step(packed, x, ck, ck, 550, kc.clone(), vc.clone(), cl, n_heads=heads)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
def test_cuda_served_loop_stamps_sum_to_each_launchs_device_time():
    """While a profiler records, the served AR loop (models/musicgen/model.
    generate) hands D a row of stamps a step: at MusicGen-medium's width and
    depth each step's stamped phases sum to within 5% of that launch's
    device time, the split names D's seven phases, and the codes equal
    those of the same loop with no profiler (and so no stamps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from torch.profiler import ProfilerActivity, profile

    from flux_generator_tpu_torch.models.musicgen import model as mg
    from flux_generator_tpu_torch.runtime import profiling

    cfg = mg.MusicGenConfig(codebook_size=64, bos_token_id=64, text_d_model=64)
    g = torch.Generator("cuda").manual_seed(0)
    params = mg.init_musicgen(g, cfg, torch.bfloat16, "cuda")
    cond = (torch.randn((2, 12, cfg.hidden_size), generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    steps = 24

    def run():
        gens = [torch.Generator("cuda").manual_seed(i) for i in range(2)]
        return mg.generate(params, cfg, cond, steps, 8, 1.0, 3.0, generators=gens, cond_len=[12, 7])

    plain = run()
    torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stamped = run()
        torch.cuda.synchronize()
    assert torch.equal(plain, stamped)
    (ar,) = [s for s in profiling.spans() if s["name"] == "fgt.musicgen.ar" and s["start_ns"] >= t0]
    launches = sorted((e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                      if "decode_step_kernel" in e.name() and e.device_type().name != "CPU")
    assert len(launches) == len(ar["d_step_ms"]) == steps
    for (_, ns), ms in zip(launches, ar["d_step_ms"]):
        assert abs(ms * 1e6 - ns) <= 0.05 * ns, (ms, ns / 1e6)
    assert tuple(ar["d_phase_ms"]) == ds.PHASE_NAMES and all(v > 0 for v in ar["d_phase_ms"].values())
    assert sum(ar["d_phase_ms"].values()) == pytest.approx(sum(ar["d_step_ms"]))
    assert ar["device_ms"] > sum(ar["d_step_ms"])
