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

Under N > 1 data-parallel ranks, ``rank_loss_fn`` gives the loss each
rank minimises so that the gradient averaged over the ranks is the
gradient of the loss over the global batch.
"""

from __future__ import annotations

import torch

from spalign_tpu_torch.parallel.dist import all_reduce_sum


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(-log softmax[label] with 0 at void pixels, the valid mask)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).to(torch.int64)
    nll = -torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    return torch.where(valid, nll, 0.0), valid


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    nll, valid = _masked_nll(logits, labels)
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


def rank_loss_fn(name: str, world: int):
    """The loss one of ``world`` ranks minimises on its rows of the global
    batch; the ranks' gradients, averaged, are the gradient of ``name``
    over the global batch, and so is the average of the values.

    'soft' and 'mse' are means over equal shards: each rank's mean is
    already right.  'ce' divides by the valid pixels of the GLOBAL batch
    (JAX: sum nll / max(sum valid, 1)); a mean over each rank's own
    valid pixels would weight the ranks wrongly whenever void pixels
    split unevenly between them, so the count is all-reduced and each
    rank's sum is scaled by ``world`` to undo the averaging."""
    fn = get_loss_fn(name)
    if world == 1 or name != "ce":
        return fn

    def global_ce(logits, labels):
        nll, valid = _masked_nll(logits, labels)
        count = all_reduce_sum(valid.sum())
        return nll.sum() * world / count.clamp(min=1)

    return global_ce
