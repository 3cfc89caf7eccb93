"""Cross-round experiment tables and plots.

Counterpart of ``spalign_tpu/eval/tables.py`` (reference
utils/make_table.py): scans results/train_*/log training logs, takes
each round's entries, emits a CSV of the best road IoU per round and a
PDF plot of it across rounds.  The CSV is the JAX package's byte for
byte.  JAX draws the plot with matplotlib, which the port does not use:
here ``rounds_iou.pdf`` is a one-page PDF 1.4 written by hand (the two
axes with ticks and tick labels, the polyline of the best values with a
marker at each, the axis titles in the standard Helvetica font); the
file name and format are JAX's, the drawing is not matplotlib's.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np


def load_round_logs(result_base_dir: str, pattern: str = "train_round*") \
        -> Dict[int, List[dict]]:
    """round number -> parsed log entries (training JSONL 'log' files)."""
    rounds = {}
    for d in sorted(glob.glob(os.path.join(result_base_dir, pattern))):
        m = re.search(r"round(\d+)", os.path.basename(d))
        if not m:
            continue
        log_fn = os.path.join(d, "log")
        if not os.path.exists(log_fn):
            continue
        with open(log_fn) as f:
            entries = json.load(f)
        rounds[int(m.group(1))] = entries
    return rounds


def best_metric_per_round(rounds: Dict[int, List[dict]],
                          key: str = "val/main/iou/road") -> Dict[int, float]:
    out = {}
    for n, entries in rounds.items():
        vals = [e[key] for e in entries if key in e]
        if vals:
            out[n] = max(vals)
    return out


def write_rounds_csv(result_base_dir: str, out_csv: Optional[str] = None,
                     keys=("val/main/iou/road", "val/main/precision",
                           "val/main/recall")) -> str:
    rounds = load_round_logs(result_base_dir)
    out_csv = out_csv or os.path.join(result_base_dir, "rounds.csv")
    cols = {k: best_metric_per_round(rounds, k) for k in keys}
    with open(out_csv, "w") as f:
        f.write("round," + ",".join(keys) + "\n")
        for n in sorted(rounds):
            row = [str(n)] + [f"{cols[k].get(n, float('nan'))}"
                              for k in keys]
            f.write(",".join(row) + "\n")
    return out_csv


# the page (points) and the plot area inside it
PAGE_W, PAGE_H = 432, 324
PLOT_X0, PLOT_Y0, PLOT_X1, PLOT_Y1 = 72, 54, 408, 300


def _pdf_text(s: str) -> str:
    return "(" + s.replace("\\", "\\\\").replace("(", "\\(").replace(
        ")", "\\)") + ")"


def _ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    """About ``n`` round-numbered ticks covering [lo, hi]."""
    raw = (hi - lo) / max(n - 1, 1)
    mag = 10.0 ** np.floor(np.log10(raw))
    step = mag * min((m for m in (1, 2, 2.5, 5, 10) if m * mag >= raw))
    return np.arange(np.floor(lo / step), np.ceil(hi / step) + 0.5) * step


def _plot_points(xs, ys):
    """Page coordinates of the data points, and the axes' ticks: x ticks
    at every round, y ticks round-numbered over the values' range."""
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    x_lo, x_hi = xs.min() - 0.5, xs.max() + 0.5
    pad = max(0.05 * (ys.max() - ys.min()), 0.01)
    yt = _ticks(ys.min() - pad, ys.max() + pad)
    y_lo, y_hi = yt[0], yt[-1]

    def px(x):
        return PLOT_X0 + (x - x_lo) / (x_hi - x_lo) * (PLOT_X1 - PLOT_X0)

    def py(y):
        return PLOT_Y0 + (y - y_lo) / (y_hi - y_lo) * (PLOT_Y1 - PLOT_Y0)

    return px(xs), py(ys), (xs, px(xs)), (yt, py(yt))


def write_plot_pdf(path: str, xs, ys, xlabel: str, ylabel: str):
    """One page: axes, ticks and labels, the polyline through (xs, ys)
    with a filled circle at each point, the axis titles in Helvetica."""
    px, py, (xt, pxt), (yt, pyt) = _plot_points(xs, ys)
    ops = ["0.5 w 0 0 0 RG",
           f"{PLOT_X0} {PLOT_Y0} {PLOT_X1 - PLOT_X0} {PLOT_Y1 - PLOT_Y0} re S"]
    text = []
    for v, p in zip(xt, pxt):
        ops.append(f"{p:.3f} {PLOT_Y0} m {p:.3f} {PLOT_Y0 - 4} l S")
        text.append((p - 3, PLOT_Y0 - 16, f"{int(v)}", 0))
    for v, p in zip(yt, pyt):
        ops.append(f"{PLOT_X0} {p:.3f} m {PLOT_X0 - 4} {p:.3f} l S")
        text.append((PLOT_X0 - 34, p - 3, f"{v:.3g}", 0))
    text.append(((PLOT_X0 + PLOT_X1) / 2 - 40, 18, xlabel, 0))
    text.append((22, (PLOT_Y0 + PLOT_Y1) / 2 - 40, ylabel, 1))
    ops.append("1.5 w 0.12 0.47 0.71 RG 0.12 0.47 0.71 rg")
    ops.append(" ".join(f"{x:.3f} {y:.3f} {'l' if i else 'm'}"
                        for i, (x, y) in enumerate(zip(px, py))) + " S")
    k = 0.5523 * 3  # a circle of radius 3 from four Bezier arcs
    for x, y in zip(px, py):
        ops.append(
            f"{x + 3:.3f} {y:.3f} m "
            f"{x + 3:.3f} {y + k:.3f} {x + k:.3f} {y + 3:.3f} {x:.3f} "
            f"{y + 3:.3f} c "
            f"{x - k:.3f} {y + 3:.3f} {x - 3:.3f} {y + k:.3f} {x - 3:.3f} "
            f"{y:.3f} c "
            f"{x - 3:.3f} {y - k:.3f} {x - k:.3f} {y - 3:.3f} {x:.3f} "
            f"{y - 3:.3f} c "
            f"{x + k:.3f} {y - 3:.3f} {x + 3:.3f} {y - k:.3f} {x + 3:.3f} "
            f"{y:.3f} c f")
    ops.append("0 0 0 rg")
    for x, y, s, vertical in text:
        tm = (f"0 1 -1 0 {x:.3f} {y:.3f}" if vertical
              else f"1 0 0 1 {x:.3f} {y:.3f}")
        ops.append(f"BT /F1 9 Tf {tm} Tm {_pdf_text(s)} Tj ET")
    stream = "\n".join(ops).encode("latin-1")
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {PAGE_W} {PAGE_H}] "
         f"/Contents 4 0 R /Resources << /Font << /F1 5 0 R >> >> >>"
         ).encode(),
        b"<< /Length %d >>\nstream\n" % len(stream) + stream
        + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
        b"/Encoding /WinAnsiEncoding >>",
    ]
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objects, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, xref))
    with open(path, "wb") as f:
        f.write(out)


def plot_rounds(result_base_dir: str, out_pdf: Optional[str] = None,
                key: str = "val/main/iou/road") -> Optional[str]:
    rounds = load_round_logs(result_base_dir)
    best = best_metric_per_round(rounds, key)
    if not best:
        return None
    xs = sorted(best)
    out_pdf = out_pdf or os.path.join(result_base_dir, "rounds_iou.pdf")
    write_plot_pdf(out_pdf, xs, [best[x] for x in xs],
                   "self-training round", key)
    return out_pdf
