"""K1, the spatial heads' attention over the encoder rows: the least time
the counted work of the requests answered in the traced slice needs (every
spatial layer, at the cell's full width), over the device time of K1's
kernels (its code pass and its attention) in the slice, in %."""

from benchmark.counts import work
from benchmark.harness.trace import kernel_seconds

KERNELS = ("spatial_codes_kernel", "spatial_attention_kernel")


def read(r):
    s, tr = r.get("slice"), r.get("trace")
    if not s or not tr or not s["answered_seg"]:
        return None
    device_s = kernel_seconds(tr, KERNELS)
    if device_s <= 0:
        return None
    nbytes, ops = work.spatial_attention_work(r["cfg"], len(s["answered_seg"]))
    return 100.0 * work.least_seconds(nbytes, ops)[0] / device_s
