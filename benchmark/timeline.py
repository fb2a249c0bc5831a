"""The traced run's profiler timeline, reduced to what the per-layer
metrics read: device operations as intervals, each tied to the benchmark
range (`bench.*`) that was open on the host when it was launched, the
benchmark's own ranges, and the union and gaps of device activity.

Ranges are `torch.profiler.record_function` spans that the benchmark's own
wrappers open around calls into the program; a device operation belongs to
the range whose host interval holds the host op that launched it (linked by
the profiler's correlation id). All times are in seconds on the profiler's
clock.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Op:
    name: str
    start: float
    end: float
    range: str  # the innermost bench.* range open at launch, or ""


@dataclass
class Timeline:
    ops: list = field(default_factory=list)  # device operations, by start
    ranges: dict = field(default_factory=dict)  # name → [(start, end)]
    host: list = field(default_factory=list)  # (start, end, name) host ops of the serving thread
    _busy: list = None

    # ---------------------------------------------------------- building

    @classmethod
    def from_profiler(cls, prof):
        """Read a finished torch.profiler.profile whose serving thread opened
        the `bench.window` range."""
        cpu, device = [], []
        for e in prof.profiler.kineto_results.events():
            start, end = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
            if e.device_type().name == "CPU":
                cpu.append((start, end, e.name(), e.correlation_id(), e.start_thread_id()))
            elif not e.is_user_annotation():
                device.append((e.name(), start, end, e.linked_correlation_id()))
        serving = next(c[4] for c in cpu if c[2] == "bench.window")
        return cls.build(device, [(s, e, n) for s, e, n, _, t in cpu if t == serving],
                         {c[3]: c[0] for c in cpu})

    @classmethod
    def build(cls, device, host, cpu_start=None):
        """device: [(name, start, end, link)]; host: [(start, end, name)];
        cpu_start: {link: the launching host op's start}."""
        tl = cls()
        for start, end, name in host:
            if name.startswith("bench."):
                tl.ranges.setdefault(name, []).append((start, end))
        tl.host = sorted(host)
        spans = sorted((s, e, n) for n, v in tl.ranges.items() for s, e in v)
        starts = [s for s, _, _ in spans]
        for name, start, end, link in sorted(device, key=lambda d: d[1]):
            launched = (cpu_start or {}).get(link)
            tl.ops.append(Op(name, start, end, _innermost(spans, starts, launched)))
        return tl

    # ---------------------------------------------------------- reading

    def window(self):
        """(start, end) of the measured window's range."""
        (start, end), = self.ranges["bench.window"]
        return start, end

    def busy(self, lo=None, hi=None):
        """The union of device intervals, clipped to [lo, hi] (the window's
        union is kept once worked out)."""
        if lo is None and hi is None and self._busy is not None:
            return self._busy
        lo_, hi_ = self.window()
        lo, hi = (lo_ if lo is None else lo), (hi_ if hi is None else hi)
        out = _union([(max(o.start, lo), min(o.end, hi)) for o in self.ops if o.end > lo and o.start < hi])
        if (lo, hi) == (lo_, hi_):
            self._busy = out
        return out

    def gaps(self, lo=None, hi=None):
        """Intervals of [lo, hi] in which no device operation ran."""
        lo = self.window()[0] if lo is None else lo
        hi = self.window()[1] if hi is None else hi
        out, t = [], lo
        for s, e in self.busy(lo, hi):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def window_s(self) -> float:
        start, end = self.window()
        return end - start

    def device_time(self, pred) -> float:
        """Summed device seconds of the operations for which pred(op) holds."""
        lo, hi = self.window()
        return sum(min(o.end, hi) - max(o.start, lo) for o in self.ops if pred(o) and o.end > lo and o.start < hi)

    def count(self, pred) -> int:
        lo, hi = self.window()
        return sum(1 for o in self.ops if pred(o) and o.start >= lo and o.start < hi)

    def host_label(self, t: float) -> str:
        """The innermost host op (range or CPU op) of the serving thread open at t."""
        best = None
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for start, end, name in (self.host[j] for j in range(i - 1, max(i - 4000, 0) - 1, -1)):
            if end >= t and (best is None or end - start < best[1] - best[0]):
                best = (start, end, name)
        return best[2] if best else "host outside any recorded op"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing."""
        by_name = {}
        lo, hi = self.window()
        for o in self.ops:
            if o.end > lo and o.start < hi:
                by_name[o.name] = by_name.get(o.name, 0.0) + min(o.end, hi) - max(o.start, lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self.host_label((s + e) / 2)[:160], e - s] for s, e in gaps]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(spans, starts, t) -> str:
    """The shortest span (start, end, name) that holds time t."""
    if t is None:
        return ""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, n in (spans[j] for j in range(i - 1, max(i - 64, 0) - 1, -1)):
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return best[2] if best else ""


def overlap(intervals, others) -> float:
    """Seconds in which an interval of one sorted list meets one of the other."""
    total, j = 0.0, 0
    others = _union(others)
    for s, e in _union(intervals):
        while j < len(others) and others[j][1] <= s:
            j += 1
        k = j
        while k < len(others) and others[k][0] < e:
            total += min(e, others[k][1]) - max(s, others[k][0])
            k += 1
    return total
