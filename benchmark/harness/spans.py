"""The serving engine's spans and counters as the per-layer readers take
them from ``readings["spans"]`` (the change between two snapshots of
``engine.spans``, ``utils.profiling.spans_delta``): a span's median, and the
traced slice's idle share split by the engine stage that left each gap.
Plain Python."""

from __future__ import annotations

import statistics
from typing import Dict, Optional

#: idle gaps named by these spans are the engine waiting for requests
STARVED = ("serve.wait_requests", "serve.coalesce")


def span_p50_ms(readings: Dict, name: str) -> Optional[float]:
    """Median ms of the engine's span ``name`` over the window's untraced
    part; None without one."""
    s = (readings.get("spans") or {}).get("spans", {}).get(name)
    if not s or not s["recent"]:
        return None
    return statistics.median((end - start) * 1e3 for start, end, _ in s["recent"])


def idle_split(readings: Dict) -> Optional[Dict[str, float]]:
    """The traced slice's idle time in % of the slice: ``starved``, the gaps
    that ``serve.wait_requests`` or ``serve.coalesce`` named (the engine
    waiting for requests), and ``host``, the rest; None when no ``serve.``
    span named a gap (an engine without spans)."""
    trace = readings.get("trace") or {}
    gaps = trace.get("idle_by_host") or {}
    if not trace.get("window_s") or not any(n.startswith("serve.") for n in gaps):
        return None
    window = trace["window_s"]
    idle = 100.0 * (window - trace["busy_s"]) / window
    starved = 100.0 * sum(v for n, v in gaps.items() if n in STARVED) / window
    return {"starved": starved, "host": idle - starved}
