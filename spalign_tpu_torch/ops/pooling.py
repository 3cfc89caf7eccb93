"""Max pooling with argmax codes + index unpooling (SegNet).

Counterpart of ``spalign_tpu/ops/pooling.py`` (Chainer's
F.MaxPooling2D(2, 2) with stored indexes and F.upsampling_2d, reference
models/segnet_basic.py:48-76).  Tensors are NHWC; the codes are int8
``2*dy + dx``.

This layer pads odd H or W with -inf (Chainer's ``cover_all`` output
size) and crops mismatched value/code shapes, in plain torch.  CUDA
tensors then go through the kernels' autograd functions
(``kernels/pooling.py``, always: there is no switch); CPU tensors go
through the plain versions, whose autograd gives the same gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spalign_tpu_torch.kernels.pooling import (MaxPoolArgmax2x2,
                                               MaxUnpool2x2,
                                               pool2x2_reference,
                                               scatter2x2_reference)


def max_pool_argmax_2x2(x: torch.Tensor):
    """x: (N, H, W, C) -> (pooled (N, ceil(H/2), ceil(W/2), C), codes
    int8 in [0, 4): window offset 2*dy + dx of the max)."""
    _, h, w, _ = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph), value=float("-inf"))
    if x.is_cuda:
        return MaxPoolArgmax2x2.apply(x.contiguous())
    return pool2x2_reference(x)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor,
                   out_hw=None) -> torch.Tensor:
    """Scatter x back to the argmax positions recorded by
    max_pool_argmax_2x2; zeros elsewhere.

    If x and idx spatial shapes differ (decoder/encoder mismatch on odd
    sizes), both are cropped to the common min shape first (reference
    models/segnet_basic.py:49-53).

    Args:
      x: (N, h, w, C) decoder activations.
      idx: (N, h, w, C) integer window offsets from the paired pooling.
      out_hw: optional (H, W) to crop the 2h x 2w output to.
    """
    if x.shape != idx.shape:
        mh = min(x.shape[1], idx.shape[1])
        mw = min(x.shape[2], idx.shape[2])
        x = x[:, :mh, :mw]
        idx = idx[:, :mh, :mw]
    idx = idx.to(torch.int8)
    if x.is_cuda:
        out = MaxUnpool2x2.apply(x.contiguous(), idx.contiguous())
    else:
        out = scatter2x2_reference(x, idx)
    if out_hw is not None:
        out = out[:, : out_hw[0], : out_hw[1]]
    return out
