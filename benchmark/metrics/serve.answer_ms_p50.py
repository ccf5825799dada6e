"""Median ms of the engine's ``serve.answer`` span over the window's untraced
part (``engine.spans``: at most its 4,096 most recent), on the consumer,
per batch: ``decode_predictions``, the stats and the futures' results."""

from benchmark.harness.spans import span_p50_ms


def read(r):
    return span_p50_ms(r, "serve.answer")
