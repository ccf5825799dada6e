"""The train step's share of the card's bf16 peak: the counted
matrix-product operations of a step (forward x 3) times the steps of the
window outside the traced slice, over those seconds and 989 TFLOP/s, in %."""

from benchmark.counts import work


def read(r):
    t = r.get("train")
    if not t or not t["steps"] or t["seconds"] <= 0:
        return None
    ops = t["steps"] * work.train_step_flops(r["cfg"], t["batch"])
    return 100.0 * ops / (t["seconds"] * work.PEAK_OPS["bf16"])
