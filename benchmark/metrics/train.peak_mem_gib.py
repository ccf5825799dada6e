"""Peak device memory the window's steps held: ``max_memory_allocated``
after a reset at the window's start, in GiB."""


def read(r):
    t = r.get("train")
    if not t or t.get("peak_bytes") is None:
        return None
    return t["peak_bytes"] / 2**30
