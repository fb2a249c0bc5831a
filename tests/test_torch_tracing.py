"""The port's spans (runtime/profiling.py) on the CPU: a span records nothing
unless a torch profiler records; under one, the tiny served engine (the
port's tiny pipelines behind FluxAPI, each behind a proxy that counts what
the engine hands it) runs a Flux request of 2 images and a music request of
2 samples, and each span appears once per unit of work, under its parent,
with the request's id and inside its own profiler range; the batch and
admit spans count the batches and items the pipelines saw, and what is
served is the same with and without the profiler."""

import gc
import json
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flux_generator_tpu_torch.runtime import profiling

BUDGET_GB = 80.0  # the planner's memory on the CPU (it reads the card's otherwise)
FLUX_REQ = {"prompt": "a red fox in snow", "width": 64, "height": 64, "steps": 2, "batch_size": 2, "seed": 5}
MUSIC_REQ = {"prompt": "slow piano and rain", "max_steps": 16, "top_k": 4, "temperature": 1.0, "guidance": 3.0,
             "seed": 9, "n_samples": 2}

# each span's count for the request above, and the span it sits under
FLUX_SPANS = {"fgt.engine.request": (1, None), "fgt.engine.admit": (2, "fgt.engine.request"),
              "fgt.engine.batch": (1, "fgt.engine.request"), "fgt.flux.cond": (1, "fgt.engine.batch"),
              "fgt.flux.step": (2, "fgt.engine.batch"), "fgt.flux.vae": (2, "fgt.engine.batch"),
              "fgt.engine.encode": (2, "fgt.engine.batch")}
MUSIC_SPANS = {"fgt.engine.request": (1, None), "fgt.engine.admit": (2, "fgt.engine.request"),
               "fgt.engine.batch": (1, "fgt.engine.request"), "fgt.musicgen.cond": (2, "fgt.engine.batch"),
               "fgt.musicgen.cross_kv": (1, "fgt.engine.batch"), "fgt.musicgen.repack": (1, "fgt.engine.batch"),
               "fgt.musicgen.ar": (1, "fgt.engine.batch"), "fgt.musicgen.codec": (2, "fgt.engine.batch")}
EXPECTED = {"flux": FLUX_SPANS, "music": MUSIC_SPANS}


class _Tok:
    """Token rows of the tiny configs' vocabularies (ids below 64, EOS 63)."""

    def encode(self, texts, **kw):
        texts = [texts] if isinstance(texts, str) else texts
        return [[1 + sum(map(ord, t)) % 50, 2, 3, 0] for t in texts]


class _Counted:
    """A pipeline behind the engine that keeps the size of each batch the
    engine hands it."""

    def __init__(self, pipe):
        self._pipe, self.calls = pipe, []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def generate_latents_batch(self, texts, seeds, **kwargs):
        self.calls.append(len(texts))
        return self._pipe.generate_latents_batch(texts, seeds, **kwargs)

    def generate_requests(self, requests, **kwargs):
        self.calls.append(len(requests))
        return self._pipe.generate_requests(requests, **kwargs)


def _engine(fam: str):
    """(FluxAPI with a tiny pipeline of `fam`, a function serving one request
    → what it returns, the proxy to put in the pipeline's slot)."""
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
    from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
    from flux_generator_tpu_torch.server.api import FluxAPI
    from flux_generator_tpu_torch.server.schemas import SDAPIRequest

    if fam == "flux":
        pipe = FluxPipeline.random_init("flux-schnell", tiny=True, dtype=torch.float32,
                                        generator=torch.Generator().manual_seed(0))
        pipe.clip_tokenizer = pipe.t5_tokenizer = _Tok()
        api = FluxAPI(pipeline_factory=lambda name: pipe, budget_gb=BUDGET_GB)

        def serve():
            return api.txt2img(SDAPIRequest(model="flux-schnell", **FLUX_REQ)).images
    else:
        # FFN 4h: the fused step's route (its plain version here), which repacks the weights
        pipe = MusicGenPipeline.random_init(generator=torch.Generator().manual_seed(2), ffn_dim=4 * 32)
        pipe.tokenizer = _Tok()
        api = FluxAPI(budget_gb=BUDGET_GB)
        api._music_factory = lambda: pipe

        def serve():
            waves, _ = api.generate_music(**MUSIC_REQ)
            return [torch.as_tensor(w).clone() for w in waves]
    return api, serve, _Counted(pipe)


@pytest.fixture(scope="module")
def runs():
    """Per family: the served outputs without and with the profiler, the
    recorder's spans of the traced request, its kineto events of the
    serving thread and the batch sizes the pipeline saw."""
    out = {}
    for fam in ("flux", "music"):
        api, serve, counted = _engine(fam)
        plain = serve()  # loads the pipeline into its slot
        if fam == "flux":
            api.pipeline = counted
        else:
            api.music_pipeline = counted
        t0 = time.time_ns()
        # no collection pauses while traced: one that lands between a span's
        # stamp and its range's edge would read as a skew of the clocks
        gc.collect()
        gc.disable()
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = serve()
        finally:
            gc.enable()
        spans = [s for s in profiling.spans() if s["start_ns"] >= t0]
        kineto = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("fgt.")]
        out[fam] = dict(plain=plain, traced=traced, spans=spans, kineto=kineto, thread=threading.get_ident(),
                        calls=list(counted.calls))
    return out


def test_spans_record_nothing_without_a_profiler():
    before = len(profiling.spans())
    with profiling.span("fgt.test.off", "cpu") as sp:
        assert sp is None
    profiling.interval("fgt.test.off", 0, 1)
    assert len(profiling.spans()) == before
    assert profiling.current_request() is None


def test_the_profilers_flag_follows_the_profiler():
    """span() reads torch.autograd.profiler._is_profiler_enabled: False with
    no profiler, True while torch.profiler.profile records, False after."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        with profiling.span("fgt.test.on") as sp:
            assert sp is not None
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.parametrize("fam", ["flux", "music"])
def test_each_span_appears_once_per_unit(runs, fam):
    names = [s["name"] for s in runs[fam]["spans"]]
    assert {n: names.count(n) for n in set(names)} == {n: c for n, (c, _) in EXPECTED[fam].items()}


@pytest.mark.parametrize("fam", ["flux", "music"])
def test_spans_sit_under_their_parents_with_the_request_id(runs, fam):
    spans = runs[fam]["spans"]
    by_id = {s["id"]: s for s in spans}
    (req,) = [s for s in spans if s["name"] == "fgt.engine.request"]
    for s in spans:
        want = EXPECTED[fam][s["name"]][1]
        assert (by_id[s["parent"]]["name"] if s["parent"] is not None else None) == want, s
        assert s["request"] == req["request"] is not None
        assert s["thread"] == runs[fam]["thread"]
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None and s["name"] != "fgt.engine.admit":
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
    (batch,) = [s for s in spans if s["name"] == "fgt.engine.batch"]
    assert batch["requests"] == [req["request"]]
    for admit in (s for s in spans if s["name"] == "fgt.engine.admit"):
        assert req["start_ns"] <= admit["start_ns"] <= admit["end_ns"] <= batch["start_ns"]
    if fam == "music":  # the AR loop alone: after the cross K/V and the repack
        (ar,) = [s for s in spans if s["name"] == "fgt.musicgen.ar"]
        assert all(s["end_ns"] <= ar["start_ns"] for s in spans
                   if s["name"] in ("fgt.musicgen.cross_kv", "fgt.musicgen.repack"))


@pytest.mark.parametrize("fam", ["flux", "music"])
def test_recorder_intervals_match_their_profiler_ranges(runs, fam):
    """Every span but the after-the-fact admit waits is a record_function
    range too: the recorder's start and end lie within 1 ms of kineto's."""
    spans = [s for s in runs[fam]["spans"] if s["name"] != "fgt.engine.admit"]
    for name in {s["name"] for s in spans}:
        mine = sorted((s["start_ns"], s["end_ns"]) for s in spans if s["name"] == name)
        theirs = sorted((s, e) for n, s, e in runs[fam]["kineto"] if n == name)
        assert len(mine) == len(theirs), name
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < 1e6 and abs(e0 - e1) < 1e6, (name, s0 - s1, e0 - e1)


@pytest.mark.parametrize("fam", ["flux", "music"])
def test_batch_and_admit_spans_count_the_batches_and_items_the_pipeline_saw(runs, fam):
    spans, calls = runs[fam]["spans"], runs[fam]["calls"]
    assert len([s for s in spans if s["name"] == "fgt.engine.batch"]) == len(calls) == 1
    assert len([s for s in spans if s["name"] == "fgt.engine.admit"]) == sum(calls) == 2


@pytest.mark.parametrize("fam", ["flux", "music"])
def test_served_outputs_are_the_same_with_and_without_the_profiler(runs, fam):
    plain, traced = runs[fam]["plain"], runs[fam]["traced"]
    assert len(plain) == len(traced) == 2
    if fam == "flux":
        assert plain == traced
    else:
        assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_the_buffer_is_bounded():
    rec = profiling.Recorder(limit=4)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            with rec.span(f"fgt.test.{i}"):
                pass
    assert [s["name"] for s in rec.spans()] == [f"fgt.test.{i}" for i in range(6, 10)]


def test_tensor_attributes_read_as_plain_values():
    """What a span keeps as tensors (D's reduced stamps) reads as numbers and
    lists, and reads the same a second time."""
    rec = profiling.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("fgt.test.attrs") as sp:
            sp.attrs.update(total=torch.tensor(2.5), each=torch.tensor([1.0, 1.5]),
                            named=dict(zip("ab", torch.tensor([0.5, 2.0]).unbind())), ids=[1, 2])
    for read in rec.spans(), rec.spans():
        (s,) = read
        assert (s["total"], s["each"], s["named"], s["ids"]) == (2.5, [1.0, 1.5], {"a": 0.5, "b": 2.0}, [1, 2])
        json.dumps(s)


def test_d_stamps_reduce_to_phase_and_step_ms():
    """models/musicgen/model._stamped over synthetic stamps of 3 steps and 2
    layers: phase j of layer l in step t lasts (t + 1)·(j + 1)·(l + 1) µs."""
    from flux_generator_tpu_torch.models.musicgen.model import _stamped
    from flux_generator_tpu_torch.ops.kernels.decode_step import PHASE_NAMES

    steps, layers, n = 3, 2, len(PHASE_NAMES)
    ns = torch.tensor([[(t + 1) * (j + 1) * (l + 1) * 1000 for l in range(layers) for j in range(n)]
                       for t in range(steps)])
    stamps = torch.cat([torch.zeros((steps, 1), dtype=torch.int64), ns.cumsum(1)], dim=1) + 10 ** 12
    got = {k: profiling._plain(v) for k, v in _stamped(stamps, layers).items()}
    assert got["d_step_ms"] == pytest.approx([(t + 1) * 28 * 3 / 1e3 for t in range(steps)])
    assert got["d_phase_ms"] == pytest.approx({p: 6 * (j + 1) * 3 / 1e3 for j, p in enumerate(PHASE_NAMES)})


def test_spans_nest_per_thread_and_requests_take_new_ids():
    rec = profiling.Recorder()
    seen = {}

    def other():
        with rec.span("fgt.test.other") as sp:
            seen["other"] = sp.parent, sp.request

    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("fgt.test.outer", new_request=True) as outer:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with rec.span("fgt.test.inner") as inner:
                assert rec.current_request() == outer.request
        with rec.span("fgt.test.next", new_request=True) as nxt:
            pass
    assert not t.is_alive()
    assert inner.parent == outer.id and inner.request == outer.request
    assert seen["other"] == (None, None)
    assert nxt.request == outer.request + 1 and rec.current_request() is None


def test_trace_writes_spans_beside_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("fgt.test.traced", "cpu"):
            torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
    got = json.loads(Path(tmp_path / "spans.json").read_text())
    assert [s["name"] for s in got["spans"]] == ["fgt.test.traced"]
    assert "device_ms" not in got["spans"][0]


def test_paths_outside_the_coalescer_hold_a_request_and_an_encode_an_image():
    """generate_images (a batch past the coalescer's buckets) and img2img:
    one `fgt.engine.request` each, and under it one `fgt.engine.encode` an
    image served."""
    from flux_generator_tpu_torch.server.schemas import Img2ImgRequest
    from tests.test_torch_server import _mock_api, _png

    api = _mock_api()
    img2img = Img2ImgRequest(prompt="x", init_images=[_png(torch.zeros((64, 64, 3), dtype=torch.uint8).numpy())],
                             width=64, height=64, steps=2, batch_size=2,
                             model="stabilityai/stable-diffusion-2-1-base")
    for call in (lambda: api.generate_images("x", width=64, height=64, steps=2, batch_size=3),
                 lambda: api.img2img(img2img).images):
        t0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            images = call()
        spans = [s for s in profiling.spans() if s["start_ns"] >= t0]
        (req,) = [s for s in spans if s["name"] == "fgt.engine.request"]
        encodes = [s for s in spans if s["name"] == "fgt.engine.encode"]
        assert len(encodes) == len(images) > 1
        assert all(s["parent"] == req["id"] and s["request"] == req["request"] for s in encodes)
