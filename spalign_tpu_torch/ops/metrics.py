"""Semantic-segmentation metrics on tensors.

Counterpart of ``spalign_tpu/ops/metrics.py`` (chainercv's
calc_semantic_segmentation_confusion / _iou, reference
batch_spalign_kmeans.py:398-405, train_segnet.py:136-143).  Ground-truth
pixels with label < 0 ('void') are ignored.
"""

from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor,
                     n_class: int = 2) -> torch.Tensor:
    """(n_class, n_class) int64 confusion with rows = gt, cols = pred;
    gt < 0 ignored.  Accepts any leading shape."""
    pred = pred.reshape(-1).to(torch.int64)
    gt = gt.reshape(-1).to(torch.int64)
    idx = torch.where(gt >= 0, gt * n_class + pred, n_class * n_class)
    counts = torch.bincount(idx, minlength=n_class * n_class + 1)
    return counts[: n_class * n_class].reshape(n_class, n_class)


def iou_from_confusion(conf: torch.Tensor) -> torch.Tensor:
    """Per-class IoU: diag / (rowsum + colsum - diag); classes absent
    from both gt and pred give NaN (0/0), as chainercv does."""
    conf = conf.to(torch.float64)
    diag = torch.diagonal(conf)
    return diag / (conf.sum(0) + conf.sum(1) - diag)


def precision_recall_from_confusion(conf: torch.Tensor):
    """Binary road precision/recall from a 2x2 confusion
    (reference batch_spalign_kmeans.py:400-404):
    TP = conf[1,1], FP = conf[0,1], FN = conf[1,0]."""
    conf = conf.to(torch.float64)
    tp, fp, fn = conf[1, 1], conf[0, 1], conf[1, 0]
    return tp / (tp + fp), tp / (tp + fn)
