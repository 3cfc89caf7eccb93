"""Device: share of the traced window in which no operation ran on the
card (100 x (1 - busy / window))."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
