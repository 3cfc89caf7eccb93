"""Training curves drawn with numpy and written as PNG (the counterpart of
the JAX package's ``Trainer._plots``, which draws them with matplotlib;
the reference's PlotReport set, train_segnet.py:291-303).

At each evaluation point ``Trainer.fit`` writes ``loss.png``,
``ious.png``, ``prerec.png`` and ``accuracy.png`` into its result
directory, one series a log key (``CURVES``), and skips a file whose
series are all empty.  A figure is ``WIDTH`` x ``HEIGHT`` pixels on
white: a light grid at five ticks an axis, the plot box in black, tick
labels and the "iteration" x label in the 5x7 bitmap font of
``utils/viz.py``, each series a polyline with a filled marker at each
point in matplotlib's default colour cycle, and a legend below the
label (a line of the series' colour, then its key), so nothing covers
the data.  Non-finite values are left out, as matplotlib leaves them
out.  ``frame`` gives the data-to-pixel map, so a reader can find each
value's pixel.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import numpy as np

from spalign_tpu_torch.data.png import write_png
from spalign_tpu_torch.utils.viz import text_mask

# the four figures and their series (JAX's Trainer._plots, trainer.py:
# 241-247)
CURVES = {
    "loss.png": ["main/loss", "val/main/loss"],
    "ious.png": ["val/main/iou/road", "val/main/iou/non_road"],
    "prerec.png": ["val/main/precision", "val/main/recall"],
    "accuracy.png": ["val/main/class_accuracy/road",
                     "val/main/class_accuracy/non_road"],
}
WIDTH, HEIGHT = 640, 480  # matplotlib's default figure at 100 dpi
LEFT, RIGHT, TOP = 72, 16, 16  # the plot box's margins, in pixels
# rows below the box: tick labels, the x label (scale 2), the legend
TICKS_BELOW, LABEL_BELOW, LEGEND_BELOW = 8, 23, 45
LEGEND_ROW = 12
N_TICKS = 5
PAD = 0.05  # of the data's span, on each side of the box
MARKER_RADIUS = 2
# matplotlib's default colour cycle (tab10: C0, C1, ...)
COLORS = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                   [214, 39, 40]], np.uint8)
GRID = np.array([222, 222, 222], np.uint8)


class Frame(NamedTuple):
    """The plot box (pixels: left, top, right, bottom, inclusive) and the
    data range it spans."""

    left: int
    top: int
    right: int
    bottom: int
    x_range: tuple
    y_range: tuple


def series(log: Sequence[dict], key: str):
    """(iterations, values) of ``key`` over the log's records, finite
    values only."""
    pts = [(float(e["iteration"]), float(e[key])) for e in log
           if key in e and e[key] is not None
           and math.isfinite(float(e[key]))]
    return [p[0] for p in pts], [p[1] for p in pts]


def _data_range(values) -> tuple:
    lo, hi = min(values), max(values)
    span = hi - lo if hi > lo else max(abs(lo), 1.0)
    return lo - PAD * span, hi + PAD * span


def frame(data) -> Frame:
    """The plot box and data range of ``data`` ([(key, xs, ys)], at
    least one point)."""
    bottom_margin = LEGEND_BELOW + LEGEND_ROW * len(data) + 4
    xs = [x for _, sx, _ in data for x in sx]
    ys = [y for _, _, sy in data for y in sy]
    return Frame(LEFT, TOP, WIDTH - RIGHT - 1, HEIGHT - bottom_margin - 1,
                 _data_range(xs), _data_range(ys))


def to_pixel(fr: Frame, x: float, y: float) -> tuple:
    """(row, column) of the data point (x, y) in the figure."""
    (x0, x1), (y0, y1) = fr.x_range, fr.y_range
    col = fr.left + (x - x0) / (x1 - x0) * (fr.right - fr.left)
    row = fr.bottom - (y - y0) / (y1 - y0) * (fr.bottom - fr.top)
    return int(round(row)), int(round(col))


def _text(img, text, row, col, scale=1, align="left"):
    """Black text with its top at ``row``; ``col`` its left edge, right
    edge (align 'right') or centre ('center'); clipped to the image."""
    m = text_mask(text, scale)
    if align == "right":
        col -= m.shape[1]
    elif align == "center":
        col -= m.shape[1] // 2
    r0, c0 = max(row, 0), max(col, 0)
    r1 = min(row + m.shape[0], img.shape[0])
    c1 = min(col + m.shape[1], img.shape[1])
    if r1 > r0 and c1 > c0:
        img[r0:r1, c0:c1][m[r0 - row:r1 - row, c0 - col:c1 - col]] = 0


def _segment(img, p, q, color):
    """A line from pixel p to pixel q, two pixels thick."""
    n = max(abs(q[0] - p[0]), abs(q[1] - p[1])) + 1
    rows = np.rint(np.linspace(p[0], q[0], n)).astype(int)
    cols = np.rint(np.linspace(p[1], q[1], n)).astype(int)
    for dr, dc in ((0, 0), (0, 1), (1, 0)):
        r = np.clip(rows + dr, 0, img.shape[0] - 1)
        c = np.clip(cols + dc, 0, img.shape[1] - 1)
        img[r, c] = color


def _marker(img, p, color):
    rr, cc = np.mgrid[-MARKER_RADIUS:MARKER_RADIUS + 1,
                      -MARKER_RADIUS:MARKER_RADIUS + 1]
    disk = rr * rr + cc * cc <= MARKER_RADIUS * MARKER_RADIUS + 1
    r = np.clip(p[0] + rr[disk], 0, img.shape[0] - 1)
    c = np.clip(p[1] + cc[disk], 0, img.shape[1] - 1)
    img[r, c] = color


def _ticks(lo_hi) -> np.ndarray:
    """N_TICKS values spread over the unpadded data range."""
    x0, x1 = lo_hi
    span = (x1 - x0) / (1 + 2 * PAD)
    lo = x0 + PAD * span
    return np.linspace(lo, lo + span, N_TICKS)


def draw_curves(data) -> np.ndarray:
    """(HEIGHT, WIDTH, 3) uint8 figure of ``data``: [(key, xs, ys)], the
    series in order (an empty series keeps its colour and legend row)."""
    if not any(xs for _, xs, _ in data):
        raise ValueError("draw_curves needs a point")
    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    fr = frame(data)
    for v in _ticks(fr.x_range):
        _, col = to_pixel(fr, v, fr.y_range[0])
        img[fr.top:fr.bottom + 1, col] = GRID
        _text(img, f"{v:.4g}", fr.bottom + TICKS_BELOW, col,
              align="center")
    for v in _ticks(fr.y_range):
        row, _ = to_pixel(fr, fr.x_range[0], v)
        img[row, fr.left:fr.right + 1] = GRID
        _text(img, f"{v:.4g}", row - 3, fr.left - 6, align="right")
    img[fr.top, fr.left:fr.right + 1] = 0
    img[fr.bottom, fr.left:fr.right + 1] = 0
    img[fr.top:fr.bottom + 1, fr.left] = 0
    img[fr.top:fr.bottom + 1, fr.right] = 0
    _text(img, "iteration", fr.bottom + LABEL_BELOW,
          (fr.left + fr.right) // 2, scale=2, align="center")
    for i, (key, xs, ys) in enumerate(data):
        color = COLORS[i % len(COLORS)]
        pts = [to_pixel(fr, x, y) for x, y in zip(xs, ys)]
        for p, q in zip(pts, pts[1:]):
            _segment(img, p, q, color)
        for p in pts:
            _marker(img, p, color)
        row = fr.bottom + LEGEND_BELOW + LEGEND_ROW * i
        img[row + 3:row + 5, fr.left:fr.left + 24] = color
        _text(img, key, row, fr.left + 32)
    return img


def write_curves(log: Sequence[dict], result_dir: str) -> list:
    """Write every figure of ``CURVES`` with a point into ``result_dir``;
    returns the paths written."""
    paths = []
    for fn, keys in CURVES.items():
        data = [(k, *series(log, k)) for k in keys]
        if not any(xs for _, xs, _ in data):
            continue
        path = os.path.join(result_dir, fn)
        write_png(path, draw_curves(data))
        paths.append(path)
    return paths
