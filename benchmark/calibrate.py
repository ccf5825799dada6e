#!/usr/bin/env python3
"""Readings from which a cell's limits are set (not run by the benchmark's
own runs): for each seed, the cell's set-up, a short window at the cell's
own load and the check, with the numbers compared for the program and, with
``--control``, for the control: the reference computed in fp8 (e4m3, one
scale per tensor) in the program's place; with ``--fault``, for the program
with a fault of ``faults.py`` planted. One JSON line per seed.

    python3 benchmark/calibrate.py --workload c3.serve.greedy --seeds 1 2 3 --seconds 3 --control
    python3 benchmark/calibrate.py --workload c3.serve.greedy --seeds 4 --fault mmt_bias_left_out
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults  # noqa: E402
from benchmark.harness.common import set_caches  # noqa: E402

set_caches()


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    from benchmark.harness.cell import make_ctx, run_ctx

    ctx = make_ctx(cell, seed, seconds, False, device, time.perf_counter(), control)
    out = run_ctx(ctx)
    line = {"seed": seed, "setup_s": ctx.setup_s, "e2e": out["e2e"],
            "checks": {k: v["value"] for k, v in out["checks"].items()}}
    cal = out["calibration"]
    for key in ("program_gaps", "control_gaps"):
        if key in cal:
            line[key.replace("_gaps", "_max")] = max(cal[key])
    for key in ("distinct_answers", "checked"):
        if key in cal:
            line[key] = cal[key]
    for key in ("program", "control"):
        if isinstance(cal.get(key), dict):
            line[key] = cal[key]
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = parser.parse_args(argv)
    import torch

    from benchmark.harness.cell import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.fault:
        faults.plant(args.fault)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.control, torch.device("cuda", 0)),
                         default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
