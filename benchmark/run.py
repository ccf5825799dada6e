#!/usr/bin/env python3
"""Run one cell of the benchmark of ``sam_textvqa_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card. The cell, its
configuration, traffic mix, limits and per-layer metrics are found by name
from ``BENCHMARK.json`` (``harness/common.py:cell_files``). Set-up builds the
program's state from the seed and warms every shape the traffic uses; the
window then measures for ``--seconds``; a sample of what the window produced
is held against the plain reference. The last line of standard output is
the result, one JSON object; with ``--trace 1`` its metrics are the cell's
per-layer metrics, read from a profiled slice of the window.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), so that set-up counts the
    interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.common import set_caches  # noqa: E402

set_caches()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness.cell import load_cell, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["cell"]["chips"]:
        print(f"benchmark: the cell needs {cell['cell']['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    from benchmark.harness.common import forbidden_modules, report

    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result", file=sys.stderr)
        return 3
    report(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
