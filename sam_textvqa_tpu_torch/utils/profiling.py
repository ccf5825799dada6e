"""Profiling hooks (JAX ``utils/profiling.py``).

* :func:`trace` — a context manager over ``torch.profiler`` (CPU and, on
  the card, CUDA activities) that writes a Chrome trace (``.json``) which
  TensorBoard's profiler plugin and ``chrome://tracing`` load;
* :class:`StepTimer` — steps per second and step latency percentiles, the
  JAX summary's keys. On a CUDA run its exit synchronizes the device, so a
  step's time is the device's, not the time to queue its launches;
* :class:`Spans` — named host spans and counters of one component (the
  serving engine's ``engine.spans``), kept in memory. While a profiler
  runs, a span also enters a profiler range, so that it lies on the
  trace's host rows, on the clock of the device's events.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block: ``with trace("traces/run") as prof: step(...)``.
    Writes ``<log_dir>/trace_<pid>.json`` on exit; yields the
    ``torch.profiler.profile`` (None when not ``enabled``). Every thread's
    operations and spans are recorded, the serving engine's threads too
    (by default the profiler records only the thread that starts it)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """``with timer: step()`` records one step. ``device`` (default: the
    current CUDA device when there is one) is synchronized at each exit."""

    def __init__(self, batch_size: int, device: Optional[torch.device] = None):
        self.batch_size = batch_size
        self.times: List[float] = []
        self._t0: Optional[float] = None
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self._sync = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "steps": int(t.size),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p95_ms": float(np.percentile(t, 95) * 1e3),
            "samples_per_sec": float(self.batch_size / t.mean()),
        }


#: recent spans a :class:`Spans` keeps per name
SPAN_WINDOW = 4096


class _Span:
    """One ``with spans(name, batch=...)`` block; ``t0`` and ``t1`` hold its
    start and end on ``time.perf_counter`` once it has closed."""

    __slots__ = ("_spans", "name", "batch", "profiled", "t0", "t1", "_range")

    def __init__(self, spans: "Spans", name: str, batch, profiled: bool):
        self._spans, self.name, self.batch, self.profiled = spans, name, batch, profiled

    def __enter__(self) -> "_Span":
        # a profiler range only while a profiler runs: on a CPU build the
        # fast one costs about 0.7 us with none running, record_function 12 us
        self._range = None
        if self.profiled and _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._spans.record(self.name, self.t0, self.t1, self.batch)
        return False


class Spans:
    """Host spans and counters of one component, in memory.

    ``with spans("serve.stack", batch=seq): ...`` times a block on
    ``time.perf_counter``: per name, a count, a total and the
    ``SPAN_WINDOW`` most recent spans as (start, end, batch or request
    id). ``record`` enters a span whose ends were read elsewhere, ``add``
    adds to a named counter. Read them through :meth:`snapshot` (for
    :func:`spans_delta`) or :meth:`summary`; nothing is written out.

    While a ``torch.profiler`` session runs, a span also enters a profiler
    range of its name (``record_function``'s fast form; skipped with
    ``profiled=False``). A profiler started with its default settings
    records only ranges of the thread that started it (:func:`trace`
    records every thread). A range lies on the profiler's device rows too
    when it encloses launches of device work, where it would count as
    device time: time such a block with ``profiled=False``. A span name
    must not start with ``bench.`` or contain ``Synchronize``,
    ``cudaEventQuery`` or ``cudaStreamWaitEvent`` (the benchmark's trace
    reader treats those ranges as its own or as waits). Safe to use from
    several threads.
    """

    def __init__(self, counters: Iterable[str] = ()):
        self._lock = threading.Lock()
        #: name -> [count, total seconds, deque of (start, end, id)]
        self._spans: Dict[str, list] = {}
        self._counters: Dict[str, float] = {c: 0 for c in counters}

    def __call__(self, name: str, batch=None, profiled: bool = True) -> _Span:
        return _Span(self, name, batch, profiled)

    def record(self, name: str, start: float, end: float, batch=None) -> None:
        with self._lock:
            entry = self._spans.get(name)
            if entry is None:
                entry = self._spans[name] = [0, 0.0, deque(maxlen=SPAN_WINDOW)]
            entry[0] += 1
            entry[1] += end - start
            entry[2].append((start, end, batch))

    def add(self, counter: str, value: float = 1) -> None:
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + value

    def snapshot(self) -> Dict:
        """{"at": perf_counter, "spans": {name: {"count", "total_s",
        "recent": [(start, end, id), ...]}}, "counters": {name: value}}."""
        with self._lock:
            return {"at": time.perf_counter(),
                    "spans": {n: {"count": c, "total_s": t, "recent": list(r)}
                              for n, (c, t, r) in self._spans.items()},
                    "counters": dict(self._counters)}

    def summary(self) -> Dict:
        """Per span its count, total and the p50 / p95 of its recent
        durations in ms; the counters."""
        return summarize_spans(self.snapshot())


def spans_delta(before: Dict, after: Dict) -> Dict:
    """What :class:`Spans` recorded between two snapshots, in the snapshot's
    form: counts, totals and counters as differences, and the spans entered
    since ``before`` (at most the recorder's window)."""
    spans = {}
    for name, b in after["spans"].items():
        a = before["spans"].get(name, {"count": 0, "total_s": 0.0})
        n = b["count"] - a["count"]
        if n > 0:
            spans[name] = {"count": n, "total_s": b["total_s"] - a["total_s"],
                           "recent": b["recent"][-n:]}
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    return {"at": after["at"], "seconds": after["at"] - before["at"], "spans": spans,
            "counters": counters}


def summarize_spans(snap: Dict) -> Dict:
    """A snapshot (or delta) as ``{"spans": {name: {"count", "total_ms",
    "p50_ms", "p95_ms"}}, "counters": {...}}``."""
    out = {}
    for name, s in sorted(snap["spans"].items()):
        ms = np.asarray([(e - b) * 1e3 for b, e, _ in s["recent"]], np.float64)
        out[name] = {"count": s["count"], "total_ms": s["total_s"] * 1e3,
                     "p50_ms": float(np.percentile(ms, 50)) if ms.size else None,
                     "p95_ms": float(np.percentile(ms, 95)) if ms.size else None}
    return {"spans": out, "counters": dict(sorted(snap["counters"].items()))}
