"""The whole decode's share of the card's bf16 peak while the card is busy:
the counted matrix-product operations of the requests answered in the
traced slice (each at the full width, its beams, no padding rows), over the
slice's device-busy seconds and 989 TFLOP/s, in %. At a fixed offered rate
the busy time, and not the window, is what a faster decode shortens."""

from benchmark.counts import work


def read(r):
    s, tr = r.get("slice"), r.get("trace")
    if not s or not tr or not s["answered_seg"] or not tr.get("busy_s"):
        return None
    ops = len(s["answered_seg"]) * work.decode_flops(r["cfg"], r.get("beams", 1))
    return 100.0 * ops / (tr["busy_s"] * work.PEAK_OPS["bf16"])
