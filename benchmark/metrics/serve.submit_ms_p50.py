"""Median ms of the engine's ``serve.submit`` span over the window's untraced
part (``engine.spans``: at most its 4,096 most recent), on the caller's
thread, per request: ``_prepare`` (validate, copy and cast every array) and
the enqueue."""

from benchmark.harness.spans import span_p50_ms


def read(r):
    return span_p50_ms(r, "serve.submit")
