"""Device memory stats, phase timers and traces (counterpart of
flux_generator_tpu/runtime/profiling.py): CUDA's allocator counters in place
of XLA's memory_stats, torch.profiler in place of jax.profiler."""

from __future__ import annotations

import contextlib
import time

import torch


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


class PhaseTimer:
    """Named phase spans (host clock; a phase that queues device work must
    end with a synchronize to measure it)."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        lines = [f"{k}: {v:.2f}s" for k, v in self.phases.items()]
        mem = device_memory_stats()
        if mem["peak_bytes_in_use"]:
            lines.append(f"peak device memory: {mem['peak_bytes_in_use'] / 1e9:.2f} GB")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "fgt-trace"):
    """torch.profiler over the CPU and, where there is a card, CUDA; writes a
    Chrome trace (trace.json) into `log_dir` and yields the profiler."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = pathlib.Path(log_dir)
    with profile(activities=activities) as prof:
        yield prof
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
