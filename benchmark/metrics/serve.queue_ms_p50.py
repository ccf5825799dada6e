"""Median ms of the engine's ``serve.queue`` span over the window's untraced
part (``engine.spans``: at most its 4,096 most recent), per request, from
its enqueue to its group's close: the wait for the batcher."""

from benchmark.harness.spans import span_p50_ms


def read(r):
    return span_p50_ms(r, "serve.queue")
