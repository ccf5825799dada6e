"""The serving harness's senders against an engine that answers after a
fixed delay: a closed loop keeps exactly its clients' requests outstanding
and stops with none lost; the traffic's ``arrivals`` picks the sender."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from benchmark.harness.serve import ClosedLoop, OpenLoop, arrivals


class DelayEngine:
    """``submit`` answers each request ``delay`` seconds later, from a
    thread of its own; counts the requests outstanding."""

    def __init__(self, delay: float):
        self.delay = delay
        self.lock = threading.Lock()
        self.outstanding = self.most = self.submitted = 0

    def _answer(self, fut: Future, sample) -> None:
        time.sleep(self.delay)
        with self.lock:
            self.outstanding -= 1
        fut.set_result({"answer": sample})

    def submit(self, sample) -> Future:
        fut = Future()
        with self.lock:
            self.outstanding += 1
            self.submitted += 1
            self.most = max(self.most, self.outstanding)
        threading.Thread(target=self._answer, args=(fut, sample), daemon=True).start()
        return fut


@pytest.mark.parametrize("clients", [1, 4, 16, 64])
def test_closed_loop_keeps_its_clients_outstanding_and_loses_none(clients):
    engine = DelayEngine(0.05)
    samples = list(range(10))
    order = np.random.RandomState(0).permutation(len(samples))
    loop = ClosedLoop(engine, samples, clients, order).start()
    seen = []
    for _ in range(30):
        time.sleep(0.01)
        with engine.lock:
            seen.append(engine.outstanding)
    assert loop.finish(timeout=5.0) == 0
    # every client's request outstanding at once, and never one more
    assert engine.most == clients and max(seen) <= clients
    assert engine.outstanding == 0
    assert len(loop.records) == engine.submitted and not loop.inflight
    # each request, in the seeded order, answered with its own sample
    sent = sorted(loop.records, key=lambda r: r[1])
    assert [r[0] for r in sent] == [int(order[k % len(order)]) for k in range(len(sent))]
    assert all(r[3] == {"answer": r[0]} and r[1] <= r[2] for r in loop.records)


def test_closed_loop_counts_a_request_that_never_comes_back():
    class Silent:
        def submit(self, sample):
            return Future()

    loop = ClosedLoop(Silent(), [0], 3, np.zeros(1, np.int64)).start()
    time.sleep(0.05)
    assert loop.finish(timeout=0.2) == 3


def test_arrivals_pick_the_sender_from_the_traffic():
    engine, order = DelayEngine(0.0), np.arange(1)
    closed = arrivals(engine, [0], {"arrivals": {"clients": 2}}, order)
    assert isinstance(closed, ClosedLoop) and closed.clients == 2
    assert isinstance(arrivals(engine, [0], {"arrivals": {"rate_per_s": 5.0}}, order), OpenLoop)
