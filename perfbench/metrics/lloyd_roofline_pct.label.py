"""SLIC Lloyd kernel: its least time on the H100 for every dispatch in the
traced window (``counts/lloyd_bound.py`` at each unit's image count) over
the device time of the kernels named like it in the trace."""

import re

from perfbench.counts import lloyd_bound

PATTERN = re.compile(r"slic_lloyd_kernel")


def read(run):
    t = run.trace
    if not t:
        return None
    spent = sum(d for name, _, d in t["ops"] if PATTERN.search(name))
    if spent <= 0:
        return None
    cfg = run.cfg
    h, w = cfg["label_gen"]["resize_shape"]
    sp = cfg["superpixel"]
    bound = sum(lloyd_bound.bound_s(n, h, w, sp["n_slic_segments"],
                                    sp["slic_iters"])[0]
                for n in run.dispatches)
    return 100.0 * bound / spent
