"""Requests answered per batch answered over the window (ServingStats
``requests`` and ``service_ms``, counted by the engine): how full the
coalesced batches run."""


def read(r):
    w = r.get("window")
    if not w or not w["service_ms"]:
        return None
    return w["requests"] / len(w["service_ms"])
