"""The e4m3 ("f8") self-attention KV cache of MusicGen: the port's encode and
decode against the JAX package's bytes, its plain fused step (kernel D's
plain version) against the JAX Pallas kernels v1/v2/v3 in interpret mode on
int8-held e4m3 caches, the unfused layer loop and `generate` against JAX
under set_musicgen_kv_dtype("f8"), and kernel D's e4m3 tier against its plain
version on a card.

Tolerances. Encode: byte-exact, both the fused store (clamped to ±448) and
the unfused one (the NaN byte past ±464). Decode: exact for every byte but
0x7F/0xFF (NaN in e4m3fn; the JAX arithmetic decode reads them as ±480, a
value the fused store never writes). Plain fused step against JAX, 4 steps:
y within the bf16-cache bound 2e-2 · max|y| (the TPU kernel rounds its head
sums to bf16; tests/test_torch_decode_step.py); the first step's new rows,
from equal caches, at most one e4m3 step apart (a row a bf16 ulp apart may
round either way); in later steps, once the caches differ by a step here and
there, a value may land two codes away if it is also within the bf16 tier's
2e-2 · max|row|. Unfused step:
f32 on both sides, logits atol 1e-4; cache bytes equal except where a row
value lies at an e4m3 rounding midpoint, at most 0.1% of them, each one step
apart. `generate` at top_k 1: codes equal. Kernel against plain version on a
card: y within 1e-2 · max|y| (D's bound); the new rows within 1e-2 ·
max|row| plus the e4m3 step at each value's magnitude (rows that close may
round to neighbouring codes), and layer 0's, whose inputs are equal, one
e4m3 step apart at most.

jax is imported inside the tests that use it, so the `cuda` case runs on a
machine without jax: `python -m pytest --noconftest -m cuda
tests/test_torch_kv_f8.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.ops.kernels import decode_step as ds

F8 = torch.float8_e4m3fn
H, HEADS, FFN, LAYERS, S_TEXT = 32, 4, 128, 2, 6
Y_TOL = 2e-2
ROW_TOL = 2e-2


def _codes(t: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes → signed code order (±0 one code)."""
    u = t.view(torch.uint8).to(torch.int32)
    return torch.where(u >= 128, -(u & 0x7F), u)


def _steps_apart(a, b) -> torch.Tensor:
    return (_codes(a) - _codes(b)).abs()


def _bytes(a) -> np.ndarray:
    """A JAX int8 (e4m3-byte) array or a torch e4m3 tensor → uint8 numpy."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _from_jax_bytes(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).view(np.uint8))).view(F8)


SPECIALS = [1000.0, -1000.0, 480.0, 470.0, -470.0, 464.0, -464.0, 460.0, 448.0, -448.0, 447.0,
            2.0 ** -9, -(2.0 ** -9), 2.0 ** -10, 3 * 2.0 ** -10, 2.0 ** -6, 0.0, -0.0, 1e-3, -0.33]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_encode_matches_jax_bytes(route, dtype):
    """store_kv_rows (fused: clamped) and _kv_store (unfused: no clamp)
    against their JAX twins, on the format's edges, subnormals, ±0 and
    values over six decades."""
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu.ops.pallas import decode_layer as jdl
    from flux_generator_tpu_torch.models.musicgen import model as tmg

    rng = np.random.default_rng(0)
    rand = rng.standard_normal(4000) * 10.0 ** rng.uniform(-4, 2.7, 4000)
    x = np.concatenate([SPECIALS, rand]).astype(np.float32)
    xj = jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    if route == "fused":
        want, got = jdl.store_kv_rows(xj, jnp.int8), ds.store_kv_rows(xt, F8)
    else:
        want, got = jmg._kv_store(xj, jnp.int8), tmg._kv_store(xt, F8)
    assert got.dtype == F8
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    nan_bytes = np.isin(_bytes(got), [0x7F, 0xFF])
    assert nan_bytes.any() == (route == "unfused")  # only the unfused store overflows to NaN


def test_decode_matches_jax_for_every_byte():
    """Every e4m3 byte widened by the port (to f32 and to bf16) against the
    TPU kernels' arithmetic `_f8_decode` and the unfused route's bitcast
    `_kv_load`, exact for all bytes but the NaN pair 0x7F/0xFF."""
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu.ops.pallas.decode_layer import _f8_decode
    from flux_generator_tpu_torch.models.musicgen import model as tmg

    b = np.arange(256, dtype=np.uint8)
    finite = ~np.isin(b, [0x7F, 0xFF])
    t = torch.from_numpy(b.copy()).view(F8)
    j = jnp.asarray(b.view(np.int8))
    got32 = tmg._kv_load(t, torch.float32).numpy()
    got16 = tmg._kv_load(t, torch.bfloat16).float().numpy()
    for want in (np.asarray(_f8_decode(j, jnp.float32)), np.asarray(jmg._kv_load(j, jnp.float32))):
        np.testing.assert_array_equal(got32[finite], want[finite])
        np.testing.assert_array_equal(got16[finite], want[finite])
    assert np.isnan(got32[~finite]).all()


def _fused_setup(b, w, offset, cond_len):
    """JAX bf16 int8-per-channel params packed both ways, inputs from numpy,
    caches as e4m3 bytes (JAX: int8; port: float8_e4m3fn, the same bytes)."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu.ops.pallas.decode_layer import pack_decode_weights, store_kv_rows
    from flux_generator_tpu.ops.quant import quantize_tree
    from flux_generator_tpu_torch.io.params import to_torch

    cfg = jmg.tiny_musicgen_config(hidden_size=H, num_attention_heads=HEADS, ffn_dim=FFN,
                                   num_hidden_layers=LAYERS)
    params = jmg.init_musicgen(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    params = dict(params, layers=quantize_tree(params["layers"], predicate=lambda p: True))
    rng = np.random.default_rng(1)
    cond = jnp.asarray((rng.standard_normal((b, S_TEXT, H)) * 0.3).astype(np.float32), jnp.bfloat16)
    ck, cv = (a.reshape(LAYERS, b, S_TEXT, H) for a in jmg.precompute_cross_kv(params, cfg, cond))
    kv = np.zeros((2, LAYERS, b, w, H), np.float32)
    kv[:, :, :, :offset] = rng.standard_normal((2, LAYERS, b, offset, H)) * 0.5
    kc, vc = (store_kv_rows(jnp.asarray(a), jnp.int8) for a in kv)
    xs = [jnp.asarray(rng.standard_normal((b, H)).astype(np.float32), jnp.bfloat16) for _ in range(4)]
    t = lambda a: to_torch(np.asarray(a))  # noqa: E731
    return dict(jax_packed=pack_decode_weights(params["layers"], H, FFN),
                packed=ds.pack_decode_weights(to_torch(jax.tree.map(np.asarray, params["layers"])), H, FFN),
                ck=ck, cv=cv, kc=kc, vc=vc, xs=xs, cl=jnp.asarray(cond_len, jnp.int32),
                t=t, tck=t(ck), tcv=t(cv), tcl=t(jnp.asarray(cond_len, jnp.int32)))


@pytest.mark.parametrize("impl,b", [("v1", 4), ("v2", 2), ("v3", 2)])
def test_plain_fused_step_matches_jax_on_e4m3_caches(impl, b):
    """Four steps from offset 9 of a 32-row window (several 8-row chunks on
    the JAX side), each side carrying its own caches."""
    import jax.numpy as jnp

    from flux_generator_tpu.ops.pallas import decode_layer as jdl

    s = _fused_setup(b, 32, 9, [3, 6, 1, 5][:b])
    fn = {"v1": jdl.fused_decode_step, "v2": jdl.fused_decode_step2, "v3": jdl.fused_decode_step3}[impl]
    kw = {"chunk": 8} if impl in ("v1", "v3") else {}
    jkc, jvc = s["kc"], s["vc"]
    tkc, tvc = _from_jax_bytes(jkc), _from_jax_bytes(jvc)
    for step, x in enumerate(s["xs"]):
        off = 9 + step
        jy, jkc, jvc = fn(s["jax_packed"], x, s["ck"], s["cv"], jnp.int32(off), jkc, jvc, s["cl"],
                          n_heads=HEADS, interpret=True, **kw)
        ty, tkc, tvc = ds.fused_decode_step(s["packed"], s["t"](x), s["tck"], s["tcv"], off, tkc, tvc,
                                            s["tcl"], n_heads=HEADS)
        assert tkc.dtype == F8 and jkc.dtype == jnp.int8
        jy = np.asarray(jy, np.float32)
        assert np.abs(ty.float().numpy() - jy).max() <= Y_TOL * np.abs(jy).max()
        for jc, tc in ((jkc, tkc), (jvc, tvc)):
            got, want = tc[:, :, off], _from_jax_bytes(jc)[:, :, off]
            apart = _steps_apart(got, want)
            near = (got.float() - want.float()).abs() <= ROW_TOL * want.float().abs().max()
            assert (apart <= 1).all() if step == 0 else ((apart <= 1) | ((apart == 2) & near)).all()
            np.testing.assert_array_equal(_bytes(tc[:, :, off + 1:]), _bytes(jc)[:, :, off + 1:])


def test_fused_step_seeds_the_token_with_its_unrounded_row():
    """Hazard of the fused route: the current token attends to its k/v rows
    in the compute dtype, and only the cache gets them as e4m3. A plain step
    on e4m3 caches must equal one on bf16 caches holding the same values, up
    to the new row's storage."""
    s = _fused_setup(2, 16, 5, [6, 6])
    x = s["t"](s["xs"][0])
    k8, v8 = _from_jax_bytes(s["kc"]), _from_jax_bytes(s["vc"])
    y8, k8, v8 = ds.fused_decode_step(s["packed"], x, s["tck"], s["tcv"], 5, k8, v8, n_heads=HEADS)
    y16, k16, v16 = ds.fused_decode_step(s["packed"], x, s["tck"], s["tcv"], 5,
                                         _from_jax_bytes(s["kc"]).to(torch.bfloat16),
                                         _from_jax_bytes(s["vc"]).to(torch.bfloat16), n_heads=HEADS)
    assert torch.equal(y8, y16)
    assert torch.equal(k8[:, :, 5].view(torch.uint8), ds.store_kv_rows(k16[:, :, 5], F8).view(torch.uint8))
    assert not torch.equal(k8[:, :, 5].to(torch.bfloat16), k16[:, :, 5])  # the row did round


def _model_setup(**overrides):
    import jax

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu_torch.io.params import to_torch
    from flux_generator_tpu_torch.models.musicgen import model as tmg

    jcfg = jmg.tiny_musicgen_config(**overrides)
    jp = jmg.init_musicgen(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tmg.MusicGenConfig(**dataclasses.asdict(jcfg)), to_torch(jax.tree.map(np.asarray, jp))


def test_unfused_step_matches_jax_on_e4m3_caches():
    """The plain layer loop, 4 steps into a 6-row e4m3 cache, against JAX's
    `decode_step` under set_musicgen_kv_dtype("f8"): rows are stored first
    (no clamp) and the token attends to its rounded self on both sides."""
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu.runtime.config import set_musicgen_kv_dtype
    from flux_generator_tpu_torch.models.musicgen import model as tmg

    jcfg, jp, cfg, tp = _model_setup()
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((4, 5, jcfg.hidden_size)).astype(np.float32)
    jckv = jmg.precompute_cross_kv(jp, jcfg, jnp.asarray(cond))
    tckv = tmg.precompute_cross_kv(tp, cfg, torch.from_numpy(cond))
    set_musicgen_kv_dtype("f8")
    try:
        jkc, jvc = jmg.init_kv_cache(jcfg, 4, 6, jmg.kv_cache_dtype(jnp.float32))
        tkc, tvc = tmg.init_kv_cache(cfg, 4, 6, tmg.kv_cache_dtype("f8", torch.float32))
        assert jkc.dtype == jnp.int8 and tkc.dtype == F8
        for off in range(4):
            tok = rng.integers(0, jcfg.codebook_size + 1, (4, 1, jcfg.num_codebooks))
            jl, jkc, jvc = jmg.decode_step(jp, jcfg, jnp.asarray(tok), jckv, jkc, jvc, jnp.int32(off))
            tl, tkc, tvc = tmg.decode_step(tp, cfg, torch.from_numpy(tok), tckv, tkc, tvc, off)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    finally:
        set_musicgen_kv_dtype(None)
    for jc, tc in ((jkc, tkc), (jvc, tvc)):
        apart = _steps_apart(tc, _from_jax_bytes(jc))
        assert apart.max() <= 1 and (apart > 0).float().mean() <= 1e-3


@pytest.mark.parametrize("fused", [False, True], ids=["plain_loop", "fused_step"])
def test_generate_codes_match_jax_on_e4m3_caches(fused):
    """`generate(kv_dtype="f8")` at top_k 1 against JAX's generate under
    set_musicgen_kv_dtype("f8"), on the route each picks: the plain loop
    (ffn = 2h) and the fused step (ffn = 4h, JAX's Pallas v1 in interpret
    mode)."""
    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.models.musicgen import model as jmg
    from flux_generator_tpu.runtime.config import set_musicgen_fused, set_musicgen_kv_dtype
    from flux_generator_tpu_torch.models.musicgen import model as tmg

    jcfg, jp, cfg, tp = _model_setup(ffn_dim=(4 if fused else 2) * 32)
    cond = np.random.default_rng(3).standard_normal((2, 5, jcfg.hidden_size)).astype(np.float32)
    set_musicgen_kv_dtype("f8")
    set_musicgen_fused(True if fused else None)
    try:
        want = jmg.generate(jp, jcfg, jnp.asarray(cond), max_steps=12, top_k=1, key=jax.random.PRNGKey(0))
    finally:
        set_musicgen_kv_dtype(None)
        set_musicgen_fused(None)
    got = tmg.generate(tp, cfg, torch.from_numpy(cond), max_steps=12, top_k=1, kv_dtype="f8")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kv_dtype_is_checked():
    from flux_generator_tpu_torch.models.musicgen import model as tmg

    assert tmg.kv_cache_dtype("bf16", torch.bfloat16) == torch.bfloat16
    assert tmg.kv_cache_dtype("f8", torch.bfloat16) == F8
    with pytest.raises(ValueError):
        tmg.kv_cache_dtype("e5m2", torch.bfloat16)
    with pytest.raises(ValueError):
        ds.store_kv_rows(torch.zeros(3), torch.float16)


def test_kernel_takes_e4m3_caches_of_one_type():
    """The wrapper's checks on the card: e4m3 K and V caches pass, mixed
    types do not."""
    g = torch.Generator().manual_seed(2)
    n = 2 * ds.CPL
    packed = {"w": torch.randint(-127, 128, (n, 256, 256), generator=g, dtype=torch.int8),
              "s": torch.ones(n, 1, 256, dtype=torch.bfloat16), "ln": torch.ones(2, 8, 256, dtype=torch.bfloat16)}
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    ck = torch.zeros(2, 2, 5, 256, dtype=torch.bfloat16)
    kc = torch.zeros(2, 2, 16, 256, dtype=F8)
    ds._check_cuda_args(packed, x, ck, ck, 3, kc, kc.clone(), None, 4)
    with pytest.raises(ValueError):
        ds._check_cuda_args(packed, x, ck, ck, 3, kc, kc.to(torch.bfloat16), None, 4)
    with pytest.raises(ValueError):
        ds._check_cuda_args(packed, x, ck, ck, 3, kc.float(), kc.float(), None, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("b,w,offset", [(2, 8, 5), (2, 300, 257), (8, 40, 33)])
def test_cuda_e4m3_tier_matches_plain_version(w_dtype, b, w, offset):
    """Kernel D on e4m3 caches against its plain version on the same inputs
    (H 256, 4 heads of 64, 2 layers, some rows with a short cond_len)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(12)
    n = 2 * ds.CPL
    if w_dtype == torch.int8:
        wt = torch.randint(-127, 128, (n, 256, 256), generator=g, dtype=torch.int8)
        sc = (0.5 + torch.rand(n, 1, 256, generator=g)) / (127 * 16)
    else:
        wt = (torch.randn(n, 256, 256, generator=g) / 16).to(w_dtype)
        sc = torch.ones(n, 1, 256)
    packed = {"w": wt, "s": sc.to(torch.bfloat16), "ln": torch.rand(2, 8, 256, generator=g).to(torch.bfloat16)}
    packed = {k: v.cuda() for k, v in packed.items()}
    x = torch.randn(b, 256, generator=g).to(torch.bfloat16).cuda()
    ck = torch.randn(2, b, 5, 256, generator=g).to(torch.bfloat16).cuda()
    kc = torch.randn(2, b, w, 256, generator=g).to(F8).cuda()
    vc = kc.flip(2).contiguous()
    cl = torch.full((b,), 5, dtype=torch.int32).cuda()
    cl[::2] = 2
    before, before8 = ds.launches, ds.e4m3_launches
    y, k1, v1 = ds.fused_decode_step(packed, x, ck, ck, offset, kc.clone(), vc.clone(), cl, n_heads=4)
    torch.cuda.synchronize()
    assert ds.launches == before + 1 and ds.e4m3_launches == before8 + 1
    ref, k2, v2 = ds.fused_decode_step_plain(packed, x, ck, ck, offset, kc.clone(), vc.clone(), cl, n_heads=4)
    assert (y.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    for got, want, orig in ((k1, k2, kc), (v1, v2, vc)):
        row, want_row = got[:, :, offset].float().cpu(), want[:, :, offset].float().cpu()
        mag = torch.maximum(row.abs(), want_row.abs()).clamp_min(2.0 ** -6)
        step = torch.exp2(torch.floor(torch.log2(mag)) - 3)  # the e4m3 step at that magnitude
        assert ((row - want_row).abs() <= 1e-2 * want_row.abs().max() + step).all()
        assert _steps_apart(got[0, :, offset].cpu(), want[0, :, offset].cpu()).max() <= 1
        rest = torch.cat([got[:, :, :offset], got[:, :, offset + 1:]], 2)
        assert torch.equal(rest.view(torch.uint8), torch.cat([orig[:, :, :offset], orig[:, :, offset + 1:]],
                                                             2).view(torch.uint8))
