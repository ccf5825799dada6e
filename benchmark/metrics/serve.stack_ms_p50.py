"""Median ms of the engine's ``serve.stack`` span over the window's untraced
part (``engine.spans``: at most its 4,096 most recent), on the batcher, per
batch: ``_route_widths`` and ``_stack``, the rows copied into the pinned
staging slot."""

from benchmark.harness.spans import span_p50_ms


def read(r):
    return span_p50_ms(r, "serve.stack")
