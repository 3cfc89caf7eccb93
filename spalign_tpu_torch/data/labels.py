"""Cityscapes labelIds remapping (the port's copy of
``spalign_tpu/data/labels.py``).

The official labelIds reduce to a 3-way mask:
  ids 0..6 ('void' categories) -> -1 (ignored in evaluation)
  id 7 ('road')                ->  1
  everything else              ->  0
"""

from __future__ import annotations

import numpy as np
import torch

VOID_IDS = (0, 1, 2, 3, 4, 5, 6)
ROAD_IDS = (7,)


def create_label_mask(label_ids: np.ndarray) -> np.ndarray:
    """(H, W) labelIds uint8 -> (H, W) int32 in {-1, 0, 1}."""
    assert label_ids.ndim == 2
    out = np.zeros(label_ids.shape, dtype=np.int32)
    out[np.isin(label_ids, VOID_IDS)] = -1
    out[np.isin(label_ids, ROAD_IDS)] = 1
    return out


def remap_label_ids(label_ids: torch.Tensor) -> torch.Tensor:
    """Tensor form of :func:`create_label_mask` (the JAX package's
    ``remap_label_ids``): raw labelIds of any shape -> int32 in
    {-1, 0, 1}."""
    ids = label_ids.to(torch.int32)
    out = torch.where(ids <= 6, -1, 0)
    return torch.where(ids == 7, 1, out).to(torch.int32)
