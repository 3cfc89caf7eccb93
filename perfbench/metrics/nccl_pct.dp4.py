"""Several ranks: share of rank 0's device time (``busy_s``) in NCCL
kernels (the gradient all-reduce and the batch norms' statistics)."""

import re

PATTERN = re.compile(r"nccl", re.IGNORECASE)


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    spent = sum(d for name, _, d in t["ops"] if PATTERN.search(name))
    return 100.0 * spent / t["busy_s"] if spent > 0 else None
