"""One run of one cell: build the system from the seed, warm it with the
requests of the cell's shapes, drive it as one closed-loop client for the
measured window, reduce what was measured to the cell's metrics, free the
program's state, and compare a sample of what it served with the plain
reference.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
checks in `workloads/<cell>.json`, the configuration in the file that
BENCHMARK.json names, the traffic mix in `traffic/<mix>.json`, the family's
module in `families/<family>.py` and each metric's reader in
`metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "flux_generator_tpu")


@dataclass
class Record:
    """One request of the window: when it was due (the previous one's
    return, or the window's start), when it returned, what it returned."""
    req: dict
    due: float
    done: float = math.inf
    units: float = 0.0
    output: object = None
    error: str = ""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == name]
    (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    from benchmark.traffic import generator

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, cell["chips"], json.loads((ROOT / conf["file"]).read_text()), generator.load(cell["traffic"]),
                json.loads((HERE / "workloads" / f"{name}.json").read_text()),
                [m for m in bench["end_to_end"] if applies(m)], [m for m in bench["per_layer"] if applies(m)])


def family(config: dict):
    return importlib.import_module(f"benchmark.families.{config['family']}")


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rate(records, close: float):
    """(units a second, first, last): the units returned after the first
    completion inside the window up to the last, over the time between them."""
    done = sorted((r.done, r.units) for r in records if r.done <= close and not r.error)
    if len(done) < 2:
        return None, None, None
    return sum(u for _, u in done[1:]) / (done[-1][0] - done[0][0]), done[0][0], done[-1][0]


def sample(records, n: int, seed: int, prefer=None, key=None):
    """Up to n records drawn from the seed among those that returned (among
    those for which `prefer` holds, where given), and the longest by `key`."""
    ok = [r for r in records if not r.error]
    pool = [i for i, r in enumerate(ok) if prefer is None or prefer(r)]
    rng = np.random.Generator(np.random.PCG64(int(seed) ^ 0xC0FFEE))
    chosen = set(rng.choice(len(pool), size=min(n, len(pool)), replace=False).tolist()) if pool else set()
    chosen = {pool[i] for i in chosen}
    if key is not None and ok:
        chosen.add(max(range(len(ok)), key=lambda i: key(ok[i])))
    return [ok[i] for i in sorted(chosen)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", started: float = None,
        tiny: bool = False, on_system=None, control: bool = False) -> dict:
    """The result of one run (the dict printed as the last line). `tiny`
    and `device` let the CPU tests drive a small system; `on_system(system)`
    lets them break it underneath; `control` also computes the control's
    numbers on the same requests and judges them by the cell's limits
    (`control_checks`, `control_correct`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.traffic import generator

    started = time.perf_counter() if started is None else started
    cuda = str(device).startswith("cuda")
    fam = family(cell.config)
    system = fam.System(cell.config, seed, device, tiny=tiny)
    if cuda and system.plan() != cell.config["dtype"].replace("bfloat16", "bf16"):
        raise RuntimeError(f"the engine's planner does not serve {cell.config['model']} in "
                           f"{cell.config['dtype']} here: {system.plan()}")
    if on_system is not None:
        on_system(system)
    for req in generator.warmup(cell.traffic, seed):
        system.serve(req)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
    if trace:
        system.instrument()
    requests = generator.requests(cell.traffic, seed)
    records = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace else None
    if prof is not None:
        prof.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - started
    close = t0 + seconds
    with record_function("bench.window"):
        due = t0
        while due < close:
            rec = Record(next(requests), due)
            with record_function("bench.request"):
                try:
                    rec.output, rec.units = system.serve(rec.req)
                except Exception as e:  # noqa: BLE001 — a failed request is counted, the loop goes on
                    rec.error = f"{type(e).__name__}: {e}"
            rec.done = due = time.perf_counter()
            records.append(rec)
        if cuda:
            torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    timeline = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from benchmark.timeline import Timeline

        timeline = Timeline.from_profiler(prof)
        del prof
    ctx = SimpleNamespace(config=system.cfg, traffic=cell.traffic, records=records, close=close, setup_s=setup_s,
                          peak_bytes=peak, timeline=timeline, calls=system.calls, family=fam)
    metrics, failed = {}, sum(1 for r in records if r.error)
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs; the seeded weights stay
    system.release()
    if cuda:
        torch.cuda.empty_cache()
    checked = system.pick(records, cell.checks["sample"], seed)
    numbers = system.check(checked, control) if checked else {}
    limits = cell.checks["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items() if not k.startswith("control_")}
    correct = not failed and passes(checks)
    result = {"correct": correct, "attempted": len(records), "failed": failed, "metrics": metrics,
              "device": device_info(cuda, cell.chips, max(peak, setup_peak if cuda else 0))}
    if control:
        # the control's numbers judged by the same limits: it has to come out not correct
        result["control_checks"] = {k[len("control_"):]: {"value": v, "limit": limits.get(k[len("control_"):])}
                                    for k, v in numbers.items() if k.startswith("control_")}
        result["control_correct"] = passes(result["control_checks"])
    if timeline is not None:
        result["device"].update(busy_s=timeline.busy_s(), window_s=timeline.window_s())
        result["breakdown"] = timeline.breakdown()
    result["errors"] = sorted({r.error for r in records if r.error})[:5]
    result["checked_requests"] = len(checked)
    result["checks"] = checks
    return result


def passes(checks: dict) -> bool:
    """Whether there are numbers, each with a limit, and none above it."""
    return bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


def device_info(cuda: bool, chips: int, peak: int) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": peak}


def loaded_forbidden() -> list:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (compared whole: the port's name begins with it)."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
