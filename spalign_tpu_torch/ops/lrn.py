"""Local response normalization across channels (channels-last).

Counterpart of ``spalign_tpu/ops/lrn.py``, Chainer's semantics (SegNetBasic
uses n=5, k=1, alpha=1e-4/5, beta=0.75):

  y_c = x_c / (k + alpha * sum_{c' in window(c, n)} x_{c'}^2) ** beta

where the window covers n channels centred on c (n//2 each side, cut at
the edges).  ``torch.nn.functional.local_response_norm`` divides alpha by
n, which this formula does not, so it is written out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def local_response_normalization(x: torch.Tensor, n: int = 5, k: float = 2.0,
                                 alpha: float = 1e-4,
                                 beta: float = 0.75) -> torch.Tensor:
    """x: (..., C) channels-last."""
    half = n // 2
    c = x.shape[-1]
    # with one extra leading zero, the window over channel j (covering
    # [j-half, j+half]) is cs[j + n] - cs[j]
    cs = torch.cumsum(F.pad(x * x, (half + 1, half)), dim=-1)
    window_sum = cs[..., n:n + c] - cs[..., 0:c]
    return x / (k + alpha * window_sum) ** beta
