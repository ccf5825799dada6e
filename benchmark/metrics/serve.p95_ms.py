"""95th percentile of the time from when a request was due to be sent to
its answer, over the requests sent in the window's untraced part, on the
client's clock. Below the knee it reads the engine's service time and the
queue that stalls of the host leave behind; it rises before the rate
answered falls."""

import numpy as np


def read(r):
    w = r.get("window")
    if not w or not w.get("latency_ms"):
        return None
    return float(np.percentile(w["latency_ms"], 95))
