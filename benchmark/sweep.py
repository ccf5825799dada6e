#!/usr/bin/env python3
"""The knee of a serving cell, found once by a sweep (not run by the
benchmark's own runs): one engine built as the cell builds it, then for
each offered rate, requests sent on that fixed schedule for a few seconds
of ramp and ``--seconds`` measured. One JSON line per rate: the rate
answered, latency p50 and p95 from when each request was due, and the
backlog left at the end. The highest rate answered in full with a bounded
backlog is the knee. With ``--clients``, closed loops of that many waiting
clients instead: one JSON line per count, the rate answered, latency p50
and p95 from each send, and the rows per batch; the smallest count on the
plateau of the rate keeps the engine saturated.

    python3 benchmark/sweep.py --workload c3.serve.greedy --rates 300 400 500 600 700 --seconds 8
    python3 benchmark/sweep.py --workload c3.serve.capacity --clients 8 16 32 64 128
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.common import set_caches  # noqa: E402

set_caches()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    loads = parser.add_mutually_exclusive_group(required=True)
    loads.add_argument("--rates", type=float, nargs="+")
    loads.add_argument("--clients", type=int, nargs="+")
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    from benchmark.harness.cell import load_cell, make_ctx
    from benchmark.harness.common import sub_seed
    from benchmark.harness.serve import ClosedLoop, OpenLoop, build

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from sam_textvqa_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ctx = make_ctx(load_cell(args.workload), args.seed, args.seconds, False,
                   torch.device("cuda", 0), time.perf_counter())
    engine, _, samples, _ = build(ctx)
    order = np.random.RandomState(sub_seed(args.seed, "order")).permutation(len(samples))
    for clients in args.clients or []:
        loop = ClosedLoop(engine, samples, clients, order).start()
        time.sleep(2.0)
        stats, t0 = engine.stats, time.perf_counter()
        with stats.lock:
            n0, b0 = stats.requests, stats.batches
        time.sleep(args.seconds)
        t1 = time.perf_counter()
        with stats.lock:
            n1, b1 = stats.requests, stats.batches
        lost = loop.finish(timeout=120.0)
        done = [r for r in loop.records if t0 <= r[2] <= t1]
        lat = [(r[2] - r[1]) * 1e3 for r in done]
        print(json.dumps({"clients": clients, "answered_per_s": len(done) / (t1 - t0),
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "rows_per_batch": (n1 - n0) / max(b1 - b0, 1), "lost": lost,
                          "failed": sum(isinstance(r[3], BaseException) for r in done)}),
              flush=True)
    for rate in args.rates or []:
        loop = OpenLoop(engine, samples, rate, order).start()
        time.sleep(2.0)
        t0 = time.perf_counter()
        time.sleep(args.seconds)
        t1 = time.perf_counter()
        with loop.lock:
            backlog = loop.outstanding
            done = [r for r in loop.records if t0 <= r[2] <= t1]
        loop.finish(timeout=120.0)
        lat = [(r[2] - r[1]) * 1e3 for r in done]
        print(json.dumps({"offered_per_s": rate, "answered_per_s": len(done) / (t1 - t0),
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)), "backlog_at_end": backlog,
                          "sends_late_ms_p50": float(np.percentile(loop.late, 50)) * 1e3,
                          "sends_late_ms_max": max(loop.late) * 1e3}), flush=True)
    engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
