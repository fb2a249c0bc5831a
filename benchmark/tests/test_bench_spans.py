"""The readers of the program's spans on synthetic spans and timelines (CPU):
each reads its number from the spans of the traced window alone, and
nothing where the run was not traced, where the spans took no events, or
where the program has no recorder (as a commit before it)."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.harness import Record
from benchmark.timeline import Timeline

T0 = 1_800_000_000.0  # the window's start on the profiler's clock (s)
PHASES = ("qkv", "self-attention", "o + residual", "cross q + cross-attention", "cross o + residual", "up",
          "down + residual")


def _span(name, start_s, end_s, **attrs):
    return {"id": 0, "name": name, "start_ns": int(round((T0 + start_s) * 1e9)),
            "end_ns": int(round((T0 + end_s) * 1e9)), "thread": 1, "parent": None, "request": 1, **attrs}


def _ctx(spans, monkeypatch, device=(), units=(4.0,), traced=True):
    """A traced window [T0, T0 + 10 s] with the device busy over `device`
    ((start, end) s after T0), the given spans and requests' units."""
    from flux_generator_tpu_torch.runtime import profiling

    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    tl = Timeline.build([("k", T0 + s, T0 + e, None) for s, e in device], [(T0, T0 + 10.0, "bench.window")])
    return SimpleNamespace(timeline=tl if traced else None, records=[Record({}, 0.0, 1.0, u) for u in units])


# two images, an encode each (0.25 s and 0.35 s); a span before the window is not read
FLUX_SPANS = [_span("fgt.engine.encode", -5.0, -4.0),
              _span("fgt.engine.encode", 1.0, 1.25), _span("fgt.engine.encode", 2.0, 2.35),
              _span("fgt.flux.cond", 0.1, 0.2, device_ms=30.0), _span("fgt.flux.vae", 0.9, 1.0, device_ms=50.0),
              _span("fgt.flux.vae", 1.5, 1.6, device_ms=54.0)]
MUSIC_SPANS = [_span("fgt.musicgen.repack", 0.1, 0.2, device_ms=6.0),
               _span("fgt.musicgen.repack", 5.1, 5.2, device_ms=8.0),
               _span("fgt.musicgen.codec", 4.0, 4.1, device_ms=40.0),
               _span("fgt.musicgen.ar", 0.1, 4.0, d_step_ms=[4.0] * 3,
                     d_phase_ms=dict(zip(PHASES, [1.0, 3.0, 1.0, 1.0, 1.0, 2.0, 3.0]))),
               _span("fgt.musicgen.ar", 5.1, 9.0, d_step_ms=[4.0] * 5,
                     d_phase_ms=dict(zip(PHASES, [2.0, 5.0, 2.0, 2.0, 2.0, 4.0, 3.0])))]

CASES = [
    ("encode_ms.flux", FLUX_SPANS, dict(units=(2.0,)), 300.0),
    # the device busy over [1.1, 1.2] and [2.3, 3.0]: idle 0.15 + 0.3 s of the 0.6 s encoding
    ("encode_idle_ms.flux", FLUX_SPANS, dict(units=(2.0,), device=((1.1, 1.2), (2.3, 3.0))), 225.0),
    ("cond_ms.flux", FLUX_SPANS, dict(units=(2.0,)), 15.0),
    ("vae_ms.flux", FLUX_SPANS, dict(units=(2.0,)), 52.0),
    ("repack_ms.musicgen", MUSIC_SPANS, dict(units=(10.0,)), 7.0),
    ("codec_ms.musicgen", MUSIC_SPANS, dict(units=(8.0, 2.0)), 4.0),
    ("decode_attn_ms.musicgen", MUSIC_SPANS, dict(units=(10.0,)), 1.0),
]


@pytest.mark.parametrize("metric,spans,kw,want", CASES, ids=[c[0] for c in CASES])
def test_reader_reads_the_windows_spans(metric, spans, kw, want, monkeypatch):
    assert harness.reader(metric)(_ctx(spans, monkeypatch, **kw)) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("metric,spans,kw,want", CASES, ids=[c[0] for c in CASES])
def test_reader_reads_nothing_untraced_or_without_spans(metric, spans, kw, want, monkeypatch):
    read = harness.reader(metric)
    assert read(_ctx(spans, monkeypatch, traced=False, **kw)) is None
    assert read(_ctx([], monkeypatch, **kw)) is None
    assert read(_ctx([s for s in spans if s["start_ns"] < T0 * 1e9], monkeypatch, **kw)) is None


@pytest.mark.parametrize("metric", [c[0] for c in CASES])
def test_reader_reads_nothing_from_a_program_without_the_recorder(metric, monkeypatch):
    from flux_generator_tpu_torch.runtime import profiling

    ctx = _ctx([], monkeypatch)
    monkeypatch.delattr(profiling, "spans")
    assert harness.reader(metric)(ctx) is None


@pytest.mark.parametrize("metric", ["cond_ms.flux", "vae_ms.flux", "repack_ms.musicgen", "codec_ms.musicgen"])
def test_device_readers_read_nothing_from_spans_without_events(metric, monkeypatch):
    """On the CPU the spans take no events: no device time is made up."""
    spans = [{k: v for k, v in s.items() if k != "device_ms"} for s in FLUX_SPANS + MUSIC_SPANS]
    assert harness.reader(metric)(_ctx(spans, monkeypatch)) is None


def test_every_new_metric_is_declared_with_its_cells():
    import json

    from benchmark.harness import ROOT

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for metric, *_ in CASES:
        m = declared[metric]
        cells = ["flux-schnell.1024-b4"] if metric.endswith(".flux") else ["musicgen-medium.b4", "musicgen-medium.solo"]
        assert m["workloads"] == cells and m["unit"] == "ms" and m["better"] == "lower"
        assert (ROOT / "benchmark" / "metrics" / f"{metric}.py").exists()


@pytest.mark.parametrize("name,req", [
    ("flux-schnell.1024-b4", {"prompt": "a red fox", "width": 64, "height": 64, "steps": 2, "batch_size": 2,
                              "seed": 5}),
    ("musicgen-medium.b4", {"prompt": "slow piano", "max_steps": 16, "top_k": 4, "temperature": 1.0,
                            "guidance": 3.0, "seed": 9, "n_samples": 2})], ids=["flux", "music"])
def test_the_programs_batch_spans_agree_with_the_proxys_counts(name, req):
    """The tiny system under a profiler: the program's `fgt.engine.batch`
    spans are the batches the benchmark's proxy counts, and its
    `fgt.engine.admit` spans the items (the inside counterpart of
    `batch_mean.*`)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from flux_generator_tpu_torch.runtime import profiling

    cell = harness.load_cell(name)
    system = harness.family(cell.config).System(dict(cell.config, dtype="float32"), 2 ** 31 + 11, "cpu", tiny=True)
    system.serve(req)
    system.instrument()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        system.serve(req)
    names = [s["name"] for s in profiling.spans() if s["start_ns"] >= t0]
    calls = system.calls
    items = sum(n for n, _ in calls) if name.startswith("flux") else sum(c["samples"] for c in calls)
    assert names.count("fgt.engine.batch") == len(calls) == 1
    assert names.count("fgt.engine.admit") == items == 2
