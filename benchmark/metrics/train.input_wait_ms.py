"""Mean milliseconds a window's step waited for its batch: the harness's
clock around each ``next()`` on the prefetching iterator."""


def read(r):
    t = r.get("train")
    if not t or not t["input_wait_ms"]:
        return None
    return sum(t["input_wait_ms"]) / len(t["input_wait_ms"])
