"""Median of the engine's dispatch-to-answer milliseconds of the batches
answered in the window (ServingStats ``service_ms``): a batch's decode and
answer free of queueing."""

import statistics


def read(r):
    w = r.get("window")
    if not w or not w["service_ms"]:
        return None
    return statistics.median(w["service_ms"])
