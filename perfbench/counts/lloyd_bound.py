"""Least time of one launch of the SLIC Lloyd loop on an H100, counted
from the configuration's shapes (a frozen copy of the repository's
``chip_smoke.py`` arithmetic: ``lloyd_bound_ms``, ``window_pairs``,
``bound_ms``): the larger of its bytes (planar CIELAB and the initial
centres read once, the labels written once) over HBM bandwidth and its
float32 operations over the non-tensor float32 peak.  Operations: per
sweep, the score (5 multiplies, 4 adds, 1 subtract) of every (pixel,
centre) pair within the window of the initial grid, and 6 adds a pixel for
the centre sums; then one final assignment."""

from __future__ import annotations

import numpy as np

from perfbench import peaks


def grid(h: int, w: int, n_segments: int):
    """(centre rows (K,), centre columns (K,), step) of the regular grid."""
    step = (h * w / n_segments) ** 0.5
    gy = max(1, int(round(h / step)))
    gx = max(1, int(round(w / step)))
    ys = ((np.arange(gy) + 0.5) * (h / gy)).astype(np.float32)
    xs = ((np.arange(gx) + 0.5) * (w / gx)).astype(np.float32)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return yy.ravel(), xx.ravel(), step


def window_pairs(h: int, w: int, n_segments: int) -> int:
    """(pixel, centre) pairs of one image within the Chebyshev window
    2 * step of the initial centres (separable: rows x columns)."""
    cy, cx, step = grid(h, w, n_segments)
    win = np.float32(2.0 * step)
    ys = np.arange(h, dtype=np.float32)[None]
    xs = np.arange(w, dtype=np.float32)[None]
    ny = (np.abs(ys - cy[:, None]) <= win).sum(-1)
    nx = (np.abs(xs - cx[:, None]) <= win).sum(-1)
    return int((ny * nx).sum())


def bound_s(images: int, h: int, w: int, n_segments: int,
            n_iter: int) -> tuple:
    """(least seconds, "bytes" or "operations") of one launch."""
    cy, _, _ = grid(h, w, n_segments)
    k = cy.shape[0]
    hw = h * w
    n_bytes = images * (3 * hw * 4 + k * 5 * 4 + hw * 4)
    n_ops = ((n_iter + 1) * window_pairs(h, w, n_segments) * images * 10
             + n_iter * images * hw * 6)
    t_bytes = n_bytes / peaks.HBM_BYTES_PER_S
    t_ops = n_ops / peaks.F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
