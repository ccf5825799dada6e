"""Median ms of the engine's ``serve.launch`` span over the window's untraced
part (``engine.spans``: at most its 4,096 most recent), on the batcher, per
batch: ``_launch``, the input copies, the graph replay, the ids' copy and
its events."""

from benchmark.harness.spans import span_p50_ms


def read(r):
    return span_p50_ms(r, "serve.launch")
