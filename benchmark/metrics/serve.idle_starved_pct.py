"""Share of the traced slice in which the card was idle because the engine
waited for requests: the idle gaps that ``serve.wait_requests`` or
``serve.coalesce`` overlapped most, in %."""

from benchmark.harness.spans import idle_split


def read(r):
    split = idle_split(r)
    return None if split is None else split["starved"]
