"""Pooling kernels (pool, scatter, gather): the bytes a step must move
(``counts/pool_bytes.py``, at the rows of the global batch one card
holds) over HBM bandwidth, for each step whose pooling the trace holds
(pool launches / levels), over their summed device time. Read on rank 0 of the data-parallel cell.
"""

import re

from perfbench.counts import pool_bytes

PATTERN = re.compile(r"(?:namespace\)::|_GLOBAL__N_1\d+)"
                     r"(pool|scatter|gather)_kernel")


def read(run):
    t = run.trace
    if not t:
        return None
    spent, pools = 0.0, 0
    for name, _, d in t["ops"]:
        m = PATTERN.search(name)
        if m:
            spent += d
            pools += m.group(1) == "pool"
    if spent <= 0:
        return None
    cfg = run.cfg
    steps = pools / cfg["model"]["levels"]
    rows = cfg["batchsize"] // run.traffic.get("ranks", 1)
    return 100.0 * steps * pool_bytes.step_bound_s(
        cfg["model"], rows, cfg["input_shape"]) / spent
