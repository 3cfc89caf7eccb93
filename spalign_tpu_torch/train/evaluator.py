"""Evaluation: road IoU / precision / recall on a validation set.

Counterpart of ``spalign_tpu/train/evaluator.py`` (the reference's
SemanticSegmentationEvaluator + PrecisionRecallEvaluator,
train_segnet.py:268-275): an eval-mode forward, scores resized to
``eval_shape`` (1024x2048) on the device, argmax, and only the summed
2x2 confusion and the loss's (sum, count) leave the device.  Under N > 1
data-parallel ranks each rank predicts its rows of every eval batch and
the sums are all-reduced, so the integer confusion equals one device's;
a ragged tail batch (not divisible by N) runs whole on rank 0 and is
counted once.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from spalign_tpu_torch.ops.metrics import confusion_matrix
from spalign_tpu_torch.ops.resize import bilinear_resize
from spalign_tpu_torch.parallel import dist as pdist


def summarize_confusion(conf) -> dict:
    conf = np.asarray(conf, np.float64)
    tp, fp, fn, tn = conf[1, 1], conf[0, 1], conf[1, 0], conf[0, 0]
    return {
        "main/iou/road": tp / max(tp + fp + fn, 1),
        "main/iou/non_road": tn / max(tn + fp + fn, 1),
        "main/precision": tp / max(tp + fp, 1),
        "main/recall": tp / max(tp + fn, 1),
        "main/class_accuracy/road": tp / max(tp + fn, 1),
        "main/class_accuracy/non_road": tn / max(tn + fp, 1),
        "main/pixel_accuracy": (tp + tn) / max(conf.sum(), 1),
        # raw counts, as the reference's PrecisionRecallEvaluator reports
        # them (train_segnet.py:138-141)
        "main/FP": float(fp),
        "main/FN": float(fn),
    }


@torch.no_grad()
def eval_batch(model, images, labels, eval_shape, n_class: int = 2):
    """(confusion (n_class, n_class), nll sum, valid count) of one
    batch, as device tensors.  The loss is the hard softmax CE of the
    full-resolution score (val/main/loss, train_segnet.py:291-293)."""
    score = model(images).float()
    if tuple(score.shape[1:3]) != tuple(eval_shape):
        score = bilinear_resize(score, eval_shape, spatial_axes=(1, 2))
    pred = score.argmax(dim=-1)
    logp = torch.log_softmax(score, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).to(torch.int64)
    nll = -torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    return (confusion_matrix(pred, labels, n_class),
            torch.where(valid, nll, 0.0).sum(), valid.sum())


class Evaluator:
    """Callable evaluator(model) -> metrics dict over a validation loader.

    ``batches_fn()`` yields (images (B, H, W, 3) float32, labels (B, H', W')
    int with -1 = void) host arrays, the GLOBAL batch on every rank;
    labels are at ``eval_shape``.  device: 'cuda' (default; raises
    without CUDA; under ``torchrun`` ``cuda:LOCAL_RANK``) or 'cpu'."""

    def __init__(self, model, batches_fn: Callable[[], Iterable],
                 eval_shape, n_class: int = 2, device="cuda"):
        self.model = model
        self.batches_fn = batches_fn
        self.eval_shape = tuple(eval_shape)
        self.n_class = n_class
        self.device = pdist.setup(device)

    def __call__(self, model=None) -> dict:
        model = self.model if model is None else model
        was_training = model.training
        model.eval()
        total = torch.zeros((self.n_class, self.n_class), dtype=torch.int64,
                            device=self.device)
        nll_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        n_valid = torch.zeros((), dtype=torch.int64, device=self.device)
        world, rank = pdist.world_size(), pdist.rank()
        try:
            for images, labels in self.batches_fn():
                if len(images) % world == 0:
                    images = pdist.rank_slice(images, rank, world)
                    labels = pdist.rank_slice(labels, rank, world)
                elif rank:
                    continue  # the ragged tail: rank 0 counts it once
                conf, s, v = eval_batch(
                    model, torch.as_tensor(images, dtype=torch.float32,
                                           device=self.device),
                    torch.as_tensor(labels, device=self.device),
                    self.eval_shape, self.n_class)
                total += conf
                nll_sum += s
                n_valid += v
        finally:
            model.train(was_training)
        for t in (total, nll_sum, n_valid):
            pdist.all_reduce_sum(t)
        out = summarize_confusion(total.cpu().numpy())
        out["main/loss"] = float(nll_sum) / max(int(n_valid), 1)
        return out
