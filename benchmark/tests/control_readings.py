"""Readings for the limits of `correct`, on the card at a cell's own size:

    python3 -m benchmark.tests.control_readings --workload NAME --seeds 1,2,3 --seconds 8 [--control]

For each seed, one process-wide run of the cell as the benchmark runs it
(a short window at the cell's own load), then the numbers compared: the
program's, and with --control the control's (the reference a precision
below the configuration's, in the program's place) on the same requests,
judged by the cell's own limits (`control_correct`, which has to be
false). One JSON line a seed on standard output."""

from __future__ import annotations

import argparse
import gc
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        raise SystemExit("control_readings: no CUDA device")
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload)
        t0 = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, device="cuda", control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "control_correct": res.get("control_correct"),
                          "attempted": res["attempted"], "checked": res["checked_requests"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "control": {k: v["value"] for k, v in res.get("control_checks", {}).items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
