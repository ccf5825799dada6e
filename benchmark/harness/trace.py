"""A steady slice of the window under ``torch.profiler``, on every thread of
the process, reduced to what the per-layer readers need: device time by
kernel, the busy union of device operations, the slice's length, and the
device's idle gaps named by the host operation, of any thread, that
overlapped them most (the program's own spans among them)."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

#: host calls that only wait for the device: they do not name an idle gap
_WAITS = ("Synchronize", "cudaEventQuery", "cudaStreamWaitEvent", "bench.")


class Slice:
    """``with Slice() as s: ...`` profiles the block; afterwards ``s.summary``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Dict = {}
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function

        # by default the profiler records only the thread that starts it
        self.prof = self._stack.enter_context(
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    experimental_config=_ExperimentalConfig(profile_all_threads=True)))
        self._stack.enter_context(record_function("bench.slice"))
        self._torch = torch
        self._t0 = time.perf_counter()
        self._t1 = None
        return self

    def end_slice(self) -> None:
        """The slice ends here; the profiler may stop later, once the
        program is idle."""
        if self.enabled:
            self._t1 = time.perf_counter()

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        seconds = (self._t1 or time.perf_counter()) - self._t0
        self._stack.close()
        if exc[0] is None:
            self.summary = summarize(self.prof.events(), self._torch, seconds)
        return False


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events, torch, seconds: float) -> Dict:
    """Times in seconds over the ``seconds`` from the start of the
    ``bench.slice`` span (the span's recorded end is not reliable while other
    threads run operations): ``window_s``,
    ``busy_s`` (the union of device operations), ``kernels`` {name:
    device seconds}, ``device_ops`` (top 10), ``idle_by_host`` {host
    operation: the idle seconds of the gaps it overlapped most},
    ``idle_gaps`` (its top 10)."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = [e for e in events if e.name == "bench.slice" and e.device_type != cuda]
    if not marks:
        return {}
    lo = marks[0].time_range.start
    hi = lo + seconds * 1e6
    dev, host = [], []
    for e in events:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        if e.device_type == cuda:
            if not e.name.startswith("bench."):  # a span of ours, not a device operation
                dev.append((s, t, e.name))
        elif not any(w in e.name for w in _WAITS):
            host.append((s, t, e.name))
    kernels: Dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        kernels[name] += (t - s) / 1e6
    busy = _merge([(s, t) for s, t, _ in dev])
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if hi > prev:
        gaps.append((prev, hi))
    ends = [g1 for _, g1 in gaps]
    best: List[Tuple[float, str]] = [(0.0, "no host operation recorded")] * len(gaps)
    for s, t, name in host:
        i = bisect.bisect_right(ends, s)
        while i < len(gaps) and gaps[i][0] < t:
            overlap = min(t, gaps[i][1]) - max(s, gaps[i][0])
            if overlap > best[i][0]:
                best[i] = (overlap, name)
            i += 1
    by_host: Dict[str, float] = defaultdict(float)
    for (g0, g1), (_, name) in zip(gaps, best):
        by_host[name] += (g1 - g0) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "kernels": dict(kernels),
        "device_ops": [[n[:120], v] for n, v in top],
        "idle_by_host": dict(by_host),
        "idle_gaps": [[n[:120], v] for n, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:10]],
    }


def kernel_seconds(summary: Dict, names) -> float:
    """Device seconds of the kernels whose name contains any of ``names``."""
    return sum(v for k, v in summary.get("kernels", {}).items() if any(n in k for n in names))
