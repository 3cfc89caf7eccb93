"""Training losses (counterpart of ``spalign_tpu/train/losses.py``), the
reference's three modes (train_segnet.py:209-223):

  * 'ce'   — chainer F.softmax_cross_entropy: mean over non-ignored
             (label >= 0) pixels of -log softmax[label]; 0 when every
             pixel is void (denominator max(count, 1), as in JAX, where
             ``F.cross_entropy(ignore_index=-1)`` would give NaN).
  * 'soft' — -F.average(t * log_softmax(y)): the mean over ALL elements
             (pixels and classes) of the elementwise product.
  * 'mse'  — F.mean_squared_error(y, t) on raw logits vs score targets.

Layouts are the JAX package's, channels last: logits (B, H, W, C); hard
labels (B, H, W) integers with -1 = ignore; soft labels (B, H, W, C).
The losses are computed in float32 whatever the logits' type.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).to(torch.int64)
    nll = -torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def soft_label_cross_entropy(logits: torch.Tensor, soft_targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft_targets * logp).mean()


def mean_squared_error(logits: torch.Tensor, targets: torch.Tensor):
    d = logits.float() - targets
    return (d * d).mean()


def get_loss_fn(name: str):
    return {"ce": softmax_cross_entropy,
            "soft": soft_label_cross_entropy,
            "mse": mean_squared_error}[name]
