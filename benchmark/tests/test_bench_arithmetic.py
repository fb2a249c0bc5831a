"""The end-to-end and idle arithmetic on synthetic spans: the rate counts
from completion to completion, the idle share comes from the union of
device intervals; one stall moves both."""

import math
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.timeline import Timeline, overlap

from benchmark.families import flux as flux_family


def _read(metric, ctx):
    return harness.reader(metric)(ctx)


def _closed_loop(service, close):
    """Records of one client: each request due when the last returned."""
    recs, t = [], 0.0
    for i, s in enumerate(service):
        if t >= close:
            break
        recs.append(harness.Record({"index": i}, t, t + s, 4.0, None))
        t += s
    return recs


def _timeline(recs, busy_share=0.9, stall=None):
    """Each request: device busy for busy_share of it, launched inside a
    step range; then the engine's time outside every pipeline range."""
    device, host = [], [(0.0, recs[-1].done, "bench.window")]
    for r in recs:
        work = (r.done - r.due) * busy_share
        host.append((r.due, r.due + work, "bench.flux.step"))
        device.append(("gemm", r.due, r.due + work, len(host)))
    if stall:
        host.append((stall[0], stall[1], "aten::stall"))
    return Timeline.build(device, host, {i + 1: host[i][0] for i in range(len(host))})


def _ctx(recs, close, tl=None):
    return SimpleNamespace(records=recs, close=close, timeline=tl, calls=[(4, 4)] * len(recs),
                           family=flux_family, setup_s=1.0, peak_bytes=2 ** 30)


def test_rate_counts_from_completion_to_completion():
    recs = _closed_loop([2.0] * 20, 11.0)
    # completions at 2, 4, ..., 12; inside the window 2..10: 4 images each after the first
    assert harness.rate(recs, 11.0)[0] == pytest.approx(16 / 8)
    assert _read("images_per_s", _ctx(recs, 11.0)) == pytest.approx(2.0)


def test_idle_share_and_engine_idle():
    recs = _closed_loop([2.0] * 5, 10.0)
    tl = _timeline(recs)
    ctx = _ctx(recs, 10.0, tl)
    assert tl.window_s() == pytest.approx(10.0)
    assert _read("device_idle_pct.flux", ctx) == pytest.approx(10.0)
    # idle 0.2 s a request outside every range, over 4 images a request
    assert _read("engine_idle_ms.flux", ctx) == pytest.approx(1e3 * 0.2 / 4)
    assert _read("flow_step_ms.flux", ctx) == pytest.approx(1e3 * 5 * 1.8 / (5 * 16))
    assert overlap([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)


def test_one_stall_moves_rate_and_idle():
    base = [0.5] * 16
    stalled = list(base)
    stalled[3] = 0.5 + 3.0  # the device finishes its work, then the host stalls 3 s
    close = 6.0
    a, b = _closed_loop(base, close), _closed_loop(stalled, close)
    assert harness.rate(b, close)[0] < 0.85 * harness.rate(a, close)[0]
    for r in b:  # the stall is host time: the device worked 0.45 s of that request
        r.units = 4.0
    ta = _timeline(a)
    tb_dev = [("gemm", r.due, r.due + 0.45, 0) for r in b]
    tb = Timeline.build(tb_dev, [(0.0, b[-1].done, "bench.window")])
    assert 100 * (1 - tb.busy_s() / tb.window_s()) > 100 * (1 - ta.busy_s() / ta.window_s()) + 10
    assert tb.breakdown()["idle_gaps"][0][1] == pytest.approx(3.05)
    assert len(b) <= 10


def test_breakdown_labels_gaps_by_the_host_op():
    recs = _closed_loop([2.0] * 5, 10.0)
    tl = _timeline(recs, stall=(2.5, 3.5, "png_encode"))
    gaps = tl.breakdown()["idle_gaps"]
    assert gaps[0][0] in ("png_encode", "bench.window") and gaps[0][1] == pytest.approx(0.2)
    ops = tl.breakdown()["device_ops"]
    assert ops[0][0] == "gemm" and ops[0][1] == pytest.approx(9.0)
    assert math.isclose(tl.busy_s(), 9.0)
