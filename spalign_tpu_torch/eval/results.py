"""Result records: JSONL writer and aggregation.

The port's copy of ``spalign_tpu/eval/results.py``, mirroring the
reference's two-part reporting surface:
  * one JSON line per image with metrics, the flattened config and stage
    timings (batch_spalign_kmeans.py:389-424, result.json);
  * aggregation into summary.txt with mean/min/max IoU and
    micro-averaged precision/recall (utils/mean_result.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

import numpy as np


class ResultWriter:
    def __init__(self, out_dir: str, filename: str = "result.json"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)

    def append(self, record: Dict):
        self.append_many([record])

    def append_many(self, records: Iterable[Dict]):
        with open(self.path, "a") as fp:
            for r in records:
                fp.write(json.dumps(r, default=_json_default) + "\n")


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def read_results(path: str, dedup: bool = True,
                 n_imgs: Optional[int] = None) -> List[Dict]:
    """Parse a result.json, deduplicating by img_fn (keep first -- the
    reference's default; utils/mean_result.py:48-58)."""
    out, seen = [], set()
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if dedup:
                key = d.get("img_fn")
                if key in seen:
                    continue
                seen.add(key)
            out.append(d)
    if n_imgs is not None:
        out = out[:n_imgs]
    return out


def aggregate_results(records: List[Dict]) -> Dict:
    """Summary statistics as utils/mean_result.py computes them: nan-mean/
    min/max of per-image IoUs, per-image precision/recall means, and
    micro-averaged precision = sum(TP)/(sum(TP)+sum(FP)) (the README
    headline numbers)."""
    def col(name):
        return np.asarray([np.nan if r.get(name) is None else r[name]
                           for r in records], dtype=np.float64)

    road_iou = col("road_iou")
    non_road_iou = col("non_road_iou")
    tps, fps, fns = col("TP"), col("FP"), col("FN")
    return {
        "road_mean_iou": float(np.nanmean(road_iou)),
        "road_min_iou": float(np.nanmin(road_iou)),
        "road_max_iou": float(np.nanmax(road_iou)),
        "non_road_mean_iou": float(np.nanmean(non_road_iou)),
        "non_road_min_iou": float(np.nanmin(non_road_iou)),
        "non_road_max_iou": float(np.nanmax(non_road_iou)),
        "average_precision": float(np.nanmean(col("precision"))),
        "precision": float(np.nansum(tps)
                           / (np.nansum(tps) + np.nansum(fps))),
        "average_recall": float(np.nanmean(col("recall"))),
        "recall": float(np.nansum(tps) / (np.nansum(tps) + np.nansum(fns))),
        "n": len(records),
    }


def format_summary(summary: Dict) -> str:
    lines = [
        f"Road mean IoU\t:{summary['road_mean_iou']}",
        f"Road min IoU\t:{summary['road_min_iou']}",
        f"Road max IoU\t:{summary['road_max_iou']}",
        f"Non-road mean IoU\t:{summary['non_road_mean_iou']}",
        f"Average Precision\t:{summary['average_precision']}",
        f"Precision\t:{summary['precision']}",
        f"Average Recall\t:{summary['average_recall']}",
        f"Recall\t:{summary['recall']}",
        f"N\t:{summary['n']}",
    ]
    return "\n".join(lines) + "\n"


def write_summary(out_dir: str, records: List[Dict]) -> Dict:
    summary = aggregate_results(records)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.txt"), "w") as fp:
        fp.write(format_summary(summary))
    return summary
