"""Checkpoint / resume (counterpart of ``spalign_tpu/train/checkpoints.py``).

Reference behaviour: full trainer-state snapshots (model + optimizer +
updater) every val_interval as snapshot_iter_N (train_segnet.py:281-283);
resume restores the whole trainer (:305-306); inference loads only the
predictor (labels_from_segnet.py:50-51).

Here a snapshot is one ``torch.save`` file of ``Trainer.state_dict()``:
the step, the model's state_dict (parameters and BN running statistics),
the optimizer's and the learning-rate schedule's.  The format is the
port's own; the JAX package's pickled pytrees do not load here.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch


def snapshot_path(result_dir: str, step: int) -> str:
    return os.path.join(result_dir, f"snapshot_iter_{step}")


def save_snapshot(result_dir: str, step: int, state: dict) -> str:
    os.makedirs(result_dir, exist_ok=True)
    path = snapshot_path(result_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_snapshot(path: str, map_location="cpu") -> dict:
    """The saved ``Trainer.state_dict()`` (tensors on ``map_location``)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_predictor(path: str, map_location="cpu") -> dict:
    """Predictor-only view of a snapshot: the model's state_dict."""
    return load_snapshot(path, map_location)["model"]


def _step_of(path: str) -> int:
    return int(re.search(r"snapshot_iter_(\d+)$", path).group(1))


def find_snapshot(result_dir: str, step: Optional[int] = None) -> str:
    """Locate snapshot_iter_{step}, or the latest when step is None
    (the round driver's lookup, labels_from_segnet.py:38-41)."""
    snaps = [p for p in glob.glob(os.path.join(result_dir,
                                               "snapshot_iter_*"))
             if re.search(r"snapshot_iter_\d+$", p)]
    if not snaps:
        raise FileNotFoundError(f"no snapshots in {result_dir}")
    if step is not None:
        path = snapshot_path(result_dir, step)
        if path in snaps:
            return path
        raise FileNotFoundError(path)
    return max(snaps, key=_step_of)


class SnapshotCallback:
    """checkpointer(step, state) hook for Trainer.fit; keeps the newest
    ``keep_last`` snapshots when set."""

    def __init__(self, result_dir: str, keep_last: Optional[int] = None):
        self.result_dir = result_dir
        self.keep_last = keep_last

    def __call__(self, step: int, state: dict):
        save_snapshot(self.result_dir, step, state)
        if self.keep_last:
            snaps = sorted(
                (p for p in glob.glob(os.path.join(self.result_dir,
                                                   "snapshot_iter_*"))
                 if re.search(r"snapshot_iter_\d+$", p)), key=_step_of)
            for p in snaps[: -self.keep_last]:
                os.remove(p)
