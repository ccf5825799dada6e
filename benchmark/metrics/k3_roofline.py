"""K3, the fused decode step: the least time the counted work of the
batches and requests answered in the traced slice needs (the step weights
once per step of a batch, each request's valid encoder rows and decoder
rows per step), over the device time of K3's kernels in the slice, in %."""

from benchmark.counts import work
from benchmark.harness.trace import kernel_seconds

KERNELS = ("product_kernel", "layernorm_kernel", "decode_attention_kernel")


def read(r):
    s, tr = r.get("slice"), r.get("trace")
    if not s or not tr or not s["answered_seg"]:
        return None
    device_s = kernel_seconds(tr, KERNELS)
    if device_s <= 0:
        return None
    cfg = r["cfg"]
    nbytes, ops = work.decode_step_work(cfg, work.decode_valid_rows(cfg, s["answered_seg"]),
                                        s["answered_batches"] * cfg.steps)
    return 100.0 * work.least_seconds(nbytes, ops)[0] / device_s
