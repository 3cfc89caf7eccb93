"""Resize ops: bilinear score resize with half-pixel centres, and the
nearest-neighbour mask resize of cv2.

Counterpart of ``spalign_tpu/ops/resize.py``.  ``bilinear_resize`` is
``jax.image.resize(method="linear")`` (reference
models/segnet_basic.py:105-110).  Upsampling is
``F.interpolate(mode="bilinear", align_corners=False)``; ``jax.image.resize``
antialiases when it shrinks, so a shrinking resize passes
``antialias=True``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_hw, spatial_axes=(0, 1)):
    """Half-pixel-centre bilinear resize along two axes (default leading).

    For NHWC score tensors pass spatial_axes=(1, 2); for HWC use (0, 1).
    """
    ay, ax = (a % x.dim() for a in spatial_axes)
    h, w = x.shape[ay], x.shape[ax]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    others = [d for d in range(x.dim()) if d not in (ay, ax)]
    perm = others + [ay, ax]
    xt = x.permute(perm)
    lead = xt.shape[:-2]
    y = F.interpolate(xt.reshape(1, -1, h, w), size=(oh, ow),
                      mode="bilinear", align_corners=False,
                      antialias=oh < h or ow < w)
    y = y.reshape(*lead, oh, ow)
    inv = [0] * x.dim()
    for i, d in enumerate(perm):
        inv[d] = i
    return y.permute(inv)


def nn_resize_cv2(x: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.INTER_NEAREST-compatible resize of the last two dims (counterpart
    of ``spalign_tpu/ops/resize.py::nn_resize_cv2``): src = floor(dst *
    (in / out)) in float32, the ratio rounded to float32 once, clipped to
    the input.  x: (..., H, W) of any dtype; bit-exact with JAX."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])

    def src(n_out, n_in):
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        idx = torch.floor(torch.arange(n_out, dtype=torch.float32) * scale)
        return idx.to(torch.int64).clamp(0, n_in - 1).to(x.device)

    return x.index_select(-2, src(oh, h)).index_select(-1, src(ow, w))


def nn_resize_np(x: np.ndarray, out_hw) -> np.ndarray:
    """Host form of :func:`nn_resize_cv2` on numpy arrays: the float32
    index convention src = floor(dst * (src_len / dst_len)) of cv2's
    INTER_NEAREST and the native scorer, on the last two dims."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    ys = np.floor(np.arange(oh, dtype=np.float32)
                  * (np.float32(h) / np.float32(oh))).astype(np.int64)
    xs = np.floor(np.arange(ow, dtype=np.float32)
                  * (np.float32(w) / np.float32(ow))).astype(np.int64)
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    return x[..., ys, :][..., :, xs]
