#!/usr/bin/env python3
"""The serving engine's spans and counters in a benchmark cell, on the card.

    python3 tools/torch_serve_spans.py [--workload c3.serve.greedy] [--seed N]
        [--seconds 20] [--out chiprun_out/serve_spans.json]

Builds the cell as ``benchmark/run.py`` does (configuration, traffic mix,
weights and requests from the seed, the warmed ``ServingEngine``) and
drives it with the cell's traffic (its fixed rate or its closed-loop
clients). Over the window's untraced part it reads the
engine's spans (``engine.spans``): the median queue, stack, launch and
answer ms, ``stall_ms`` per second and the counters. The window's last
``trace_slice_s`` seconds are profiled on every thread and reduced as the
benchmark reduces its slice (``benchmark/harness/trace.py:summarize``);
the benchmark's own slice records only the thread that starts it, so the
engine's ranges are missing there. The slice's idle seconds are split by
the host operation that named each gap: starved (``serve.wait_requests``,
``serve.coalesce``), another engine stage, inside the launch stage (CUDA
runtime calls and PyTorch operators, which only ``serve.launch``, not a
profiler range, leaves unenclosed), or unnamed. Then the spans' host cost
per batch at B = 8 and 32: the cost of one span, record and counter add
on this host with the profiler off and on, times what the engine entered
per batch in the window. One JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
#: idle gaps named by these spans are the engine waiting for requests
STARVED = ("serve.wait_requests", "serve.coalesce")
UNNAMED = "no host operation recorded"


def span_p50_ms(delta: Dict, name: str) -> Optional[float]:
    """Median ms of span ``name`` in a ``spans_delta``; None without one."""
    s = delta["spans"].get(name)
    if not s or not s["recent"]:
        return None
    return statistics.median((end - start) * 1e3 for start, end, _ in s["recent"])


def engine_readings(delta: Dict) -> Dict:
    """The per-layer readings of a window's ``spans_delta``, and the stack
    pass's host bandwidth (``stack_bytes`` over ``serve.stack``'s time)."""
    c = delta["counters"]
    stack_s = delta["spans"].get("serve.stack", {}).get("total_s", 0.0)
    return {"serve.queue_ms_p50": span_p50_ms(delta, "serve.queue"),
            "serve.stack_ms_p50": span_p50_ms(delta, "serve.stack"),
            "serve.launch_ms_p50": span_p50_ms(delta, "serve.launch"),
            "serve.answer_ms_p50": span_p50_ms(delta, "serve.answer"),
            "serve.stall_ms_per_s": c.get("stall_ms", 0) / delta["seconds"],
            "batches": c.get("batches", 0), "requests": c.get("requests", 0),
            "slow_copies": c.get("slow_copies", 0), "stack_bytes": c.get("stack_bytes", 0),
            "stack_gb_per_s": c["stack_bytes"] / stack_s / 1e9
            if c.get("stack_bytes") and stack_s else None}


def idle_split(trace: Dict) -> Optional[Dict]:
    """A trace summary's idle seconds by the stage that left them, and the
    two idle shares in % of the slice; None when no ``serve.`` range named
    a gap (a profile of one thread, or an engine without spans)."""
    gaps = dict(trace.get("idle_gaps") or [])
    if not trace.get("window_s") or not any(n.startswith("serve.") for n in gaps):
        return None
    window, idle = trace["window_s"], trace["window_s"] - trace["busy_s"]
    starved = sum(v for n, v in gaps.items() if n in STARVED)
    stages = sum(v for n, v in gaps.items() if n.startswith("serve.") and n not in STARVED)
    unnamed = gaps.get(UNNAMED, 0.0)
    return {"serve.idle_starved_pct": 100.0 * starved / window,
            "serve.idle_host_pct": 100.0 * idle / window - 100.0 * starved / window,
            "idle_s": idle, "starved_s": starved, "other_stages_s": stages,
            "inside_launch_s": sum(gaps.values()) - starved - stages - unnamed,
            "unnamed_s": unnamed, "beyond_top_10_s": idle - sum(gaps.values())}


def span_costs(n: int) -> Dict[str, float]:
    """Host us of one span (``with``), one ``record`` and one ``add`` on a
    fresh recorder, over ``n`` of each."""
    from sam_textvqa_tpu_torch.utils.profiling import Spans

    spans, out = Spans(), {}
    t = time.perf_counter()
    for i in range(n):
        with spans("serve.cost", batch=i):
            pass
    out["span_us"] = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for i in range(n):
        spans.record("serve.cost_record", 0.0, 1.0, i)
    out["record_us"] = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        spans.add("cost")
    out["add_us"] = (time.perf_counter() - t) / n * 1e6
    return out


def cost_per_batch(delta: Dict, costs: Dict[str, float], rows: int, launch_us: float) -> float:
    """Host us the spans cost a batch of ``rows`` requests: per request a
    ``serve.submit`` span and a ``serve.queue`` record; per batch the
    window's ``serve.wait_requests`` spans per batch, six more spans, the
    ``serve.launch`` span (``launch_us``: never a profiler range) and three
    counter adds."""
    batches = max(delta["counters"].get("batches", 0), 1)
    waits = delta["spans"].get("serve.wait_requests", {}).get("count", 0) / batches
    return (rows * (costs["span_us"] + costs["record_us"]) + (waits + 6) * costs["span_us"]
            + launch_us + 3 * costs["add_us"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="c3.serve.greedy")
    p.add_argument("--seed", type=int, default=20261018)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=None, help="also write the JSON line here")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.common import card_note, set_caches

    set_caches()
    import numpy as np
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import serve as bench_serve
    from benchmark.harness.cell import load_cell, make_ctx
    from benchmark.harness.trace import summarize
    from sam_textvqa_tpu_torch.utils.compile_cache import enable_compile_cache
    from sam_textvqa_tpu_torch.utils.profiling import spans_delta, summarize_spans

    if not torch.cuda.is_available():
        print("torch_serve_spans: needs a CUDA device", file=sys.stderr)
        return 2
    enable_compile_cache()
    ctx = make_ctx(load_cell(args.workload), args.seed, args.seconds, True,
                   torch.device("cuda", 0), time.perf_counter())
    traffic = ctx.traffic
    engine, _, samples, _ = bench_serve.build(ctx)
    order = np.random.RandomState(bench_serve.sub_seed(args.seed, "order")).permutation(
        len(samples))
    loop = bench_serve.arrivals(engine, samples, traffic, order).start()
    time.sleep(traffic["warmup_s"])
    slice_s = min(traffic["trace_slice_s"], args.seconds / 2)
    before = engine.spans.snapshot()
    time.sleep(args.seconds - slice_s)
    delta = spans_delta(before, engine.spans.snapshot())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        with record_function("bench.slice"):
            t0 = time.perf_counter()
            time.sleep(slice_s)
            seconds = time.perf_counter() - t0
        loop.drain(timeout=60.0)
    lost = loop.finish(timeout=60.0)
    engine.close()
    trace = summarize(prof.events(), torch, seconds)
    off = span_costs(200_000)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)):
        on = span_costs(20_000)
    out = {
        "workload": args.workload, "seed": args.seed, "card": card_note(),
        "untraced_s": delta["seconds"], "lost": lost,
        "engine": engine_readings(delta),
        "spans": summarize_spans(delta),
        "idle": idle_split(trace),
        "trace": {"window_s": trace.get("window_s"), "busy_s": trace.get("busy_s"),
                  "idle_gaps": trace.get("idle_gaps"),
                  "serve_device_rows": sorted(k for k in trace.get("kernels", {})
                                              if k.startswith("serve."))},
        "cost_us": {"profiler_off": off, "profiler_on": on,
                    "per_batch": {str(b): {
                        "profiler_off": cost_per_batch(delta, off, b, off["span_us"]),
                        "profiler_on": cost_per_batch(delta, on, b, off["span_us"])}
                        for b in (8, 32)}},
    }
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
