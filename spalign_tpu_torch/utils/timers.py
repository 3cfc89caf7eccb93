"""Per-stage wall-clock instrumentation.

The reference writes an elapsed_times dict into every result.json record
(batch_spalign_kmeans.py:428-458: time_superpixel, time_kmeans,
elapsed_time).  StageTimer keeps that surface.  On CUDA, work is queued
asynchronously, so a stage that measures the card passes its device and
ends with ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class StageTimer:
    def __init__(self):
        self._t0 = time.time()
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, device: Optional[torch.device] = None):
        """Time a region; with a CUDA ``device`` the region ends with a
        synchronize so the time covers the queued device work."""
        st = time.time()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.times[f"time_{name}"] = (
                self.times.get(f"time_{name}", 0.0) + time.time() - st)

    def add(self, name: str, seconds: float):
        """Count ``seconds`` timed elsewhere (another thread) to a stage."""
        self.times[f"time_{name}"] = (
            self.times.get(f"time_{name}", 0.0) + seconds)

    def finish(self) -> Dict[str, float]:
        self.times["elapsed_time"] = time.time() - self._t0
        return dict(self.times)
