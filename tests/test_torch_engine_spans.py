"""The serving engine's spans and counters (``engine.spans``,
``utils/profiling.py:Spans``) on the CPU engine, and the readings that
``tools/torch_serve_spans.py`` takes from them.

* Every span name appears; ``serve.submit`` and ``serve.queue`` count one
  per request, the batch stages one per batch; durations are non-negative
  and sum, per thread, to at most the wall time; ``stack_bytes`` counts
  the served rows' bytes.
* ``stall_ms`` stays 0 while the batcher's timed gets return on time (a
  fake clock) and rises when a get returns late (a real sleep).
* With no profiler running no span enters a profiler range; under
  ``utils.profiling.trace`` the Chrome trace holds every host ``serve.*``
  range of the engine's threads and no ``serve.launch``.
* ``ServingStats`` keeps its fields (its summary is held to JAX's in
  ``test_torch_serving_front.py``).
"""

import importlib.util
import json
import threading
import time
from dataclasses import fields
from pathlib import Path
from queue import Empty

import pytest
import torch

from sam_textvqa_tpu_torch import serve
from sam_textvqa_tpu_torch.config import task_config_from_dict
from sam_textvqa_tpu_torch.data.vocab import synthetic_vocab
from sam_textvqa_tpu_torch.serving import engine as engine_mod
from sam_textvqa_tpu_torch.serving.engine import ServingEngine, ServingStats
from sam_textvqa_tpu_torch.utils import profiling
from sam_textvqa_tpu_torch.utils.profiling import (SPAN_WINDOW, Spans, spans_delta,
                                                   summarize_spans)
from test_torch_model import tiny_raw
from test_torch_model import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
BATCHER = ("serve.wait_requests", "serve.coalesce", "serve.slot_wait", "serve.stack",
           "serve.launch", "serve.handoff")
CONSUMER = ("serve.ids_wait", "serve.answer")
#: ranges a profiler sees (serve.launch and serve.queue never enter one)
PROFILED = ("serve.submit",) + tuple(n for n in BATCHER if n != "serve.launch") + CONSUMER
COUNTERS = ("batches", "requests", "stack_bytes", "slow_copies", "stall_ms")


def _tool():
    spec = importlib.util.spec_from_file_location("torch_serve_spans",
                                                  ROOT / "tools" / "torch_serve_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    task = task_config_from_dict(tiny_raw())
    vocab = synthetic_vocab(40)
    model = serve.build_model(task, len(vocab), torch.float32, seed=0, device="cpu")
    return task, vocab, model, serve.synthetic_requests(task, 7, len(vocab), seed=5)


def _engine(tiny, **kw):
    _, vocab, model, _ = tiny
    return ServingEngine(model, vocab, buckets=(1, 2, 4), device="cpu", **kw)


def test_every_span_counts_once_per_request_or_batch(tiny):
    samples = tiny[3]
    engine = _engine(tiny, max_wait_ms=20.0)
    engine.warmup()
    t0 = time.perf_counter()
    try:
        answers = [f.result(timeout=TIMEOUT) for f in engine.submit_many(samples)]
    finally:
        engine.close()
    wall = time.perf_counter() - t0
    assert len(answers) == len(samples)
    snap = engine.spans.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert set(spans) == set(PROFILED) | {"serve.launch", "serve.queue"}
    n, batches = len(samples), engine.stats.batches
    assert spans["serve.submit"]["count"] == spans["serve.queue"]["count"] == n
    assert counters["requests"] == n and counters["batches"] == batches >= 2
    for name in BATCHER[1:] + CONSUMER:
        assert spans[name]["count"] == batches, name
    assert spans["serve.wait_requests"]["count"] >= batches
    assert {e[2] for e in spans["serve.submit"]["recent"]} == set(range(n))
    assert {e[2] for e in spans["serve.stack"]["recent"]} == set(range(batches))
    for name, s in spans.items():
        assert all(end >= start for start, end, _ in s["recent"]), name
        assert s["total_s"] == pytest.approx(sum(e - b for b, e, _ in s["recent"]))
    for thread in (("serve.submit",), BATCHER, CONSUMER):
        assert sum(spans[name]["total_s"] for name in thread) <= wall, thread
    assert counters["stall_ms"] >= 0 and counters["slow_copies"] == 0
    # every served row at full width: the bytes of a batch of one, per row
    row_bytes = sum(t.nbytes for t in engine._stack([engine._prepare(samples[0])], 1).values())
    rows = sum(b * c for b, c in engine.stats.occupancy.items())
    assert counters["stack_bytes"] == rows * row_bytes
    summary = engine.spans.summary()
    assert summary["spans"]["serve.stack"]["count"] == batches
    assert summary["spans"]["serve.answer"]["p95_ms"] >= summary["spans"]["serve.answer"][
        "p50_ms"] >= 0
    assert set(summary["counters"]) == set(COUNTERS)


class _FakeClock:
    """``time`` for the engine module, advanced by the fake queue only."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now

    monotonic = perf_counter


def test_stall_ms_reads_lateness_past_the_timeout(tiny, monkeypatch):
    engine = _engine(tiny)
    clock = _FakeClock()
    monkeypatch.setattr(engine_mod, "time", clock)
    late = {"s": 0.0}

    def get(block=True, timeout=None):
        if block:
            clock.now += timeout + late["s"]
        raise Empty

    monkeypatch.setattr(engine._queue, "get", get)
    for timeout in (0.05, 0.0, 0.002):  # on time: no stall
        assert engine._timed_get(timeout) is None
    late["s"] = 0.0009  # under SLOW_S: scheduling noise, not a stall
    engine._timed_get(0.05)
    assert engine.spans.snapshot()["counters"]["stall_ms"] == 0
    late["s"] = 0.004
    engine._timed_get(0.05)
    assert engine.spans.snapshot()["counters"]["stall_ms"] == pytest.approx(4.0)
    engine.close()


def test_stall_ms_counts_a_batcher_held_past_its_timeout(tiny, monkeypatch):
    engine = _engine(tiny)
    real_get = engine._queue.get
    held = threading.Event()

    def slow_get(block=True, timeout=None):
        try:
            return real_get(block, timeout)
        finally:
            if timeout and not held.is_set():
                held.set()
                time.sleep(0.03)  # the batcher is held 30 ms past its wake-up

    monkeypatch.setattr(engine._queue, "get", slow_get)
    engine.start()
    try:
        assert held.wait(TIMEOUT)
        time.sleep(0.1)
    finally:
        engine.close()
    assert engine.spans.snapshot()["counters"]["stall_ms"] >= 25.0


def test_no_record_function_without_a_profiler(tiny, monkeypatch):
    entered = []
    real = profiling._RecordFunctionFast

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", counting)
    engine = _engine(tiny, max_wait_ms=5.0)
    try:
        assert all(f.result(timeout=TIMEOUT) for f in engine.submit_many(tiny[3][:3]))
    finally:
        engine.close()
    assert engine.spans.snapshot()["counters"]["batches"] >= 1 and entered == []
    spans = Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans("serve.x"), spans("serve.y", profiled=False):
            pass
    assert entered == ["serve.x"]


def test_chrome_trace_holds_the_engine_ranges(tiny, tmp_path):
    engine = _engine(tiny, max_wait_ms=5.0)
    engine.warmup()
    engine.start()
    try:
        with profiling.trace(str(tmp_path)):
            assert all(f.result(timeout=TIMEOUT) for f in engine.submit_many(tiny[3][:3]))
            time.sleep(0.15)  # a whole serve.wait_requests (50 ms) inside the trace
    finally:
        engine.close()
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(PROFILED) <= names
    assert "serve.launch" not in names and "serve.queue" not in names


def test_spans_delta_and_summary():
    spans = Spans(counters=("c",))
    for i in range(2):
        spans.record("a", i, i + 0.5, i)
    before = spans.snapshot()
    n = SPAN_WINDOW + 3
    for i in range(2, 2 + n):
        spans.record("a", i, i + 0.004, i)
    spans.record("b", 0.0, 0.25)
    spans.add("c", 2.5)
    spans.add("d")
    delta = spans_delta(before, spans.snapshot())
    assert delta["spans"]["a"]["count"] == n
    assert delta["spans"]["a"]["total_s"] == pytest.approx(0.004 * n)
    # the window's most recent
    assert [e[2] for e in delta["spans"]["a"]["recent"]] == list(range(5, 2 + n))
    assert delta["counters"] == {"c": 2.5, "d": 1}
    out = summarize_spans(delta)
    assert out["spans"]["a"]["p50_ms"] == pytest.approx(4.0)
    assert out["spans"]["b"] == {"count": 1, "total_ms": 250.0, "p50_ms": 250.0,
                                 "p95_ms": 250.0}
    assert spans_delta(spans.snapshot(), spans.snapshot())["spans"] == {}


def test_serving_stats_keep_their_fields():
    assert [f.name for f in fields(ServingStats)] == [
        "requests", "batches", "padded_rows", "occupancy", "ocr_width_occupancy",
        "obj_width_occupancy", "ocr_needed", "obj_needed", "group_sizes", "latencies_ms",
        "latencies_ms_by_bucket", "service_ms", "service_ms_by_bucket", "autotune", "started",
        "lock"]


def test_stats_answer_and_demo_carry_the_spans(tiny):
    engine = _engine(tiny, max_wait_ms=5.0)
    try:
        stats = serve.run_demo(engine, tiny[3], 4, concurrency=2)
        answer = serve.stats_response(engine, 7)
    finally:
        engine.close()
    assert stats["spans"]["spans"]["serve.submit"]["count"] == 4
    assert answer["spans"]["counters"]["requests"] == 4 and answer["id"] == 7


def _delta():
    spans = Spans(counters=COUNTERS)
    for i, (name, ms) in enumerate([("serve.queue", 1.0), ("serve.queue", 3.0),
                                    ("serve.queue", 2.0), ("serve.stack", 0.4),
                                    ("serve.launch", 0.9), ("serve.answer", 0.2),
                                    ("serve.wait_requests", 5.0),
                                    ("serve.wait_requests", 5.0)]):
        spans.record(name, i, i + ms / 1e3, 0)
    spans.add("stall_ms", 6.0)
    spans.add("batches", 1)
    spans.add("requests", 3)
    spans.add("stack_bytes", 4e6)
    delta = spans_delta(Spans(counters=COUNTERS).snapshot(), spans.snapshot())
    delta["seconds"] = 2.0
    return delta


def test_tool_reads_the_engine_metrics():
    tool = _tool()
    got = tool.engine_readings(_delta())
    assert got["serve.queue_ms_p50"] == pytest.approx(2.0)
    assert got["serve.stack_ms_p50"] == pytest.approx(0.4)
    assert got["serve.launch_ms_p50"] == pytest.approx(0.9)
    assert got["serve.answer_ms_p50"] == pytest.approx(0.2)
    assert got["serve.stall_ms_per_s"] == pytest.approx(3.0)
    assert (got["batches"], got["requests"], got["slow_copies"]) == (1, 3, 0)
    assert got["stack_bytes"] == 4e6 and got["stack_gb_per_s"] == pytest.approx(10.0)
    empty = {"spans": {}, "counters": {}, "seconds": 1.0}
    assert tool.engine_readings(empty)["serve.stack_ms_p50"] is None
    assert tool.engine_readings(empty)["stack_gb_per_s"] is None
    costs = {"span_us": 1.0, "record_us": 0.5, "add_us": 0.25}
    # 8 x 1.5 + (2 waits + 6) x 1 + launch 0.3 + 3 x 0.25
    assert tool.cost_per_batch(_delta(), costs, 8, 0.3) == pytest.approx(21.05)


def test_tool_splits_the_idle_time():
    tool = _tool()
    trace = {"window_s": 2.0, "busy_s": 0.5, "idle_gaps": [
        ["serve.wait_requests", 0.6], ["serve.coalesce", 0.2], ["serve.stack", 0.1],
        ["cudaMemcpyAsync", 0.3], ["no host operation recorded", 0.1]]}
    got = tool.idle_split(trace)
    assert got["serve.idle_starved_pct"] == pytest.approx(40.0)
    assert got["serve.idle_host_pct"] == pytest.approx(35.0)
    assert got["other_stages_s"] == pytest.approx(0.1)
    assert got["inside_launch_s"] == pytest.approx(0.3)
    assert got["unnamed_s"] == pytest.approx(0.1)
    assert got["beyond_top_10_s"] == pytest.approx(0.2)
    # a profile of one thread (the parent's names): nothing to split
    assert tool.idle_split({"window_s": 2.0, "busy_s": 0.7,
                            "idle_gaps": [["cudaMemcpyAsync", 1.2]]}) is None
    assert tool.idle_split({}) is None
