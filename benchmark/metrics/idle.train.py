"""Share of the traced slice of a training window in which no operation ran
on the device, in %."""


def read(r):
    tr = r.get("trace")
    if not tr or "train" not in r or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
