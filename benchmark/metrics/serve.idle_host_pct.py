"""Share of the traced slice in which the card was idle while the engine
had requests: the idle gaps named by any host operation but the batcher's
wait for requests (``serve.wait_requests``, ``serve.coalesce``), in %.
With ``serve.idle_starved_pct`` it adds up to the slice's idle share."""

from benchmark.harness.spans import idle_split


def read(r):
    split = idle_split(r)
    return None if split is None else split["host"]
