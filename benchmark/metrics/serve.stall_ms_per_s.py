"""The engine's ``stall_ms`` counter over the window's untraced part, per
second: how late the batcher's timed ``queue.get`` calls came back, summed
over those more than 1 ms past their timeout (the host holding the
batcher's thread)."""


def read(r):
    d = r.get("spans")
    if not d or "stall_ms" not in d["counters"] or d["seconds"] <= 0:
        return None
    return d["counters"]["stall_ms"] / d["seconds"]
