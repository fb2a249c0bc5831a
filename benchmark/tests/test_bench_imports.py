"""What the benchmark loads: no JAX, no Flax, no JAX package anywhere in a
run (top-level module names compared whole, since the port's name begins
with the JAX package's), and nothing of the port in the reference."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "flux_generator_tpu"}


def _modules(code: str) -> set:
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = """
import glob
from benchmark import harness, run, timeline
from benchmark.families import flux, musicgen
from benchmark.reference import flux as rf, musicgen as rm, ops, text, tokenizers
for path in glob.glob("benchmark/metrics/*.py"):
    harness.reader(path.split("/")[-1][:-3])
for name, tiny in (("flux-schnell.1024-b4", dict(width=64, height=64, batch_size=1, steps=None)), ("musicgen-medium.solo", dict(max_steps=[16, 16], top_k=4))):
    cell = harness.load_cell(name)
    cell.traffic = dict(cell.traffic, **tiny)
    cell.config = dict(cell.config, dtype="float32")
    cell.checks = {"sample": 1, "limits": {k: 1.0 for k in cell.checks["limits"]}}
    assert harness.run(cell, 3, 0.5, True, device="cpu", tiny=True)["checks"]
"""
    loaded = _modules(code)
    assert "flux_generator_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules("from benchmark.reference import flux, musicgen, ops, text, tokenizers\n"
                      "from benchmark.counts import flux as c1, musicgen as c2, peaks\n"
                      "from benchmark.traffic import generator")
    assert "flux_generator_tpu_torch" not in loaded and not loaded & FORBIDDEN
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert "flux_generator_tpu" not in path.read_text(), path
