"""Result records: one JSON line per image with metrics, the flattened
config and stage timings (reference batch_spalign_kmeans.py:389-424,
result.json)."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable

import numpy as np


class ResultWriter:
    def __init__(self, out_dir: str, filename: str = "result.json"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)

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
