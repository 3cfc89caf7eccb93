"""Bytes SegNet's argmax pooling kernels must move in one train step,
from the configuration's shapes (a frozen copy of the repository's
``chip_smoke.py`` ``pool_bytes``): every input read once, every output
written once, codes one byte.  A step runs, at each of the levels, one
pool and one scatter (the unpool) forward, and one gather (the unpool's
backward) and one scatter (the pool's backward) backward."""

from __future__ import annotations

from perfbench import peaks


def level_bytes(batch: int, h: int, w: int, c: int, itemsize: int = 4):
    big = batch * h * w * c
    small = big // 4
    return {"pool": big * itemsize + small * itemsize + small,
            "scatter": small * itemsize + small + big * itemsize,
            "gather": big * itemsize + small + small * itemsize}


def step_bytes(model: dict, batch: int, hw) -> float:
    h, w = hw
    total = 0
    for lvl in range(model["levels"]):
        b = level_bytes(batch, h >> lvl, w >> lvl, model["width"])
        total += b["pool"] + 2 * b["scatter"] + b["gather"]
    return float(total)


def step_bound_s(model: dict, batch: int, hw) -> float:
    return step_bytes(model, batch, hw) / peaks.HBM_BYTES_PER_S
