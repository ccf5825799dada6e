"""Profiling hooks (JAX ``utils/profiling.py``).

* :func:`trace` — a context manager over ``torch.profiler`` (CPU and, on
  the card, CUDA activities) that writes a Chrome trace (``.json``) which
  TensorBoard's profiler plugin and ``chrome://tracing`` load;
* :class:`StepTimer` — steps per second and step latency percentiles, the
  JAX summary's keys. On a CUDA run its exit synchronizes the device, so a
  step's time is the device's, not the time to queue its launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block: ``with trace("traces/run") as prof: step(...)``.
    Writes ``<log_dir>/trace_<pid>.json`` on exit; yields the
    ``torch.profiler.profile`` (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
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
