"""Device memory stats, spans and traces (counterpart of
flux_generator_tpu/runtime/profiling.py): CUDA's allocator counters in place
of XLA's memory_stats, torch.profiler in place of jax.profiler.

Spans mark work where it runs: `with span("fgt.flux.vae", device):`. While
no torch profiler records, a span costs one check of the profiler's flag
and records nothing. While one records, it opens a `record_function` range
of its name, so the range lands in the profiler's timeline, and keeps the
span in memory: name, start and end on `time.time_ns()` (the clock of the
profiler's CPU events), thread, parent (the innermost open span of the
thread), request id and, with a CUDA `device`, a CUDA event pair on the
current stream, resolved to `device_ms` only when the spans are read, after
the caller's own synchronize. `spans()` reads them; `trace(log_dir)` writes
them to spans.json beside the profiler's trace.json. There is no other
switch: an operator gets spans by serving inside `trace()` (docs/TRACING.md).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_LIMIT = 1 << 16  # spans kept in memory, the oldest dropped first


def device_memory_stats(device=None) -> dict:
    """Bytes in use, the peak since the last reset, and the card's total, of
    a CUDA device (the current one when None); zeros on the CPU."""
    device = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (device is not None and device.type != "cuda"):
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.get_device_properties(device or torch.cuda.current_device()).total_memory,
    }


def peak_memory_gb(device=None) -> float:
    """torch.cuda.max_memory_allocated in GB; 0.0 on the CPU."""
    return device_memory_stats(device)["peak_bytes_in_use"] / 1e9


class Span:
    """One open or finished span; the context manager `span` returns."""

    __slots__ = ("recorder", "id", "name", "start_ns", "end_ns", "thread", "parent", "request", "attrs",
                 "_range", "_events", "_outer_request")

    def __init__(self, recorder: "Recorder", name: str, device=None, new_request: bool = False):
        self.recorder, self.name = recorder, name
        self.id = next(recorder._ids)
        self.attrs: dict = {}  # kept with the span and read with it; tensors (and dicts of them) read as lists
        self._events = None
        if device is not None and torch.device(device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                            torch.cuda.current_stream(device))
        self._outer_request = recorder.current_request()
        self.request = next(recorder._requests) if new_request else self._outer_request
        self.start_ns = self.end_ns = None
        self.thread = threading.get_ident()
        self.parent = None

    def __enter__(self):
        local = self.recorder._local
        stack = local.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        local.request = self.request
        # stamped before the range opens: a profile's first range spends up to
        # milliseconds setting up after the profiler's own start stamp
        self.start_ns = time.time_ns()
        self._range = _autograd_profiler.record_function(self.name)
        self._range.__enter__()
        if self._events is not None:
            self._events[0].record(self._events[2])
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._events[2])
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        local = self.recorder._local
        local.stack.pop()
        local.request = self._outer_request
        self.recorder._spans.append(self)
        return False

    def _read(self) -> dict:
        if self._events is not None:
            start, end, _ = self._events
            end.synchronize()
            self.attrs["device_ms"] = start.elapsed_time(end)
            self._events = None
        self.attrs = {k: _plain(v) for k, v in self.attrs.items()}
        return {"id": self.id, "name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "thread": self.thread, "parent": self.parent, "request": self.request, **self.attrs}


def _plain(v):
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


class Recorder:
    """The process's spans, in a bounded buffer."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self._spans = collections.deque(maxlen=limit)
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._local = threading.local()

    def span(self, name: str, device=None, new_request: bool = False):
        """A context manager: the Span while a profiler records (events on
        `device`'s current stream if it is a CUDA device; a new request id
        for it and the spans it encloses with `new_request`), else None."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return Span(self, name, device, new_request)

    def interval(self, name: str, start_ns: int, end_ns: int, request=None):
        """A span known after the fact (a wait that began on another
        thread): kept in memory only, under the innermost open span."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        sp = Span(self, name)
        stack = getattr(self._local, "stack", None)
        sp.parent = stack[-1].id if stack else None
        sp.request, sp.start_ns, sp.end_ns = request, start_ns, end_ns
        self._spans.append(sp)

    def current_request(self):
        """The request id of the innermost open span of this thread."""
        return getattr(self._local, "request", None)

    def spans(self) -> list:
        """The finished spans kept, oldest first, each a dict (with
        `device_ms` where events were taken); synchronizes on their events."""
        return [sp._read() for sp in list(self._spans)]


_OFF = contextlib.nullcontext()
_recorder = Recorder()
span = _recorder.span
interval = _recorder.interval
current_request = _recorder.current_request
spans = _recorder.spans


@contextlib.contextmanager
def trace(log_dir: str = "fgt-trace"):
    """torch.profiler over the CPU and, where there is a card, CUDA; writes a
    Chrome trace (trace.json) and the spans recorded meanwhile
    (spans.json) into `log_dir`, and yields the profiler."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = pathlib.Path(log_dir)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    if cuda:
        torch.cuda.synchronize()
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    kept = [s for s in spans() if s["start_ns"] >= t0]
    (out / "spans.json").write_text(json.dumps({"spans": kept}))
