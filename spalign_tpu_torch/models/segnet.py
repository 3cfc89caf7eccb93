"""SegNet students (SegNetBasic and the full SegNet) as PyTorch modules.

Counterpart of ``spalign_tpu/models/segnet.py`` (reference
models/segnet_basic.py and models/segnet.py).  Encoder max-pool
positions are kept as int8 codes and the decoders scatter activations
back through them (``ops/pooling.py``: on the card the Hopper kernels of
``csrc/pooling.cu``).  Public layouts are the JAX package's: images NHWC
in, scores NHWC out.  Inside, activations are NCHW, kept
``channels_last`` on the card, so their NHWC view for the pooling ops
costs nothing.  Module names follow the flax modules (``conv1``,
``conv1_bn``, ``block3.cbr2.conv``), which is what
``convert/from_jax.py`` maps.

Matched to flax:
  * SegNetBasic's 7x7 convs have no bias, its 1x1 classifier has one;
    SegNet's CBR convs have none, its score conv has one.
  * Batch norm: eps 2e-5, running averages 0.9 * old + 0.1 * new, and the
    running variance takes the biased batch variance (flax's
    ``_compute_stats``; ``torch.nn.functional.batch_norm`` would take the
    unbiased one).  SegNetBasic's BN shift starts at 0.001, ``_CBR``'s at 0.
    Under a process group of N > 1 ranks, train mode takes the statistics
    of the global batch, as pjit's global-batch BN does
    (``nn.SyncBatchNorm`` would swap in torch's unbiased running
    variance and rejects CPU tensors).
  * Weights: he_normal, variance scaling 2.0 over fan-in, truncated
    normal; biases 0.
  * ``dtype=torch.bfloat16`` is flax's mixed precision: parameters stay
    float32, convolutions and BN outputs run in bfloat16, so the pooling
    kernels see bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce

from spalign_tpu_torch.ops.lrn import local_response_normalization
from spalign_tpu_torch.ops.pooling import max_pool_argmax_2x2, max_unpool_2x2
from spalign_tpu_torch.ops.resize import bilinear_resize
from spalign_tpu_torch.parallel.dist import world_size
from spalign_tpu_torch.utils.device import resolve_device
from spalign_tpu_torch.utils.timers import span

# stddev of the unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Conv2d):
    """'Same'-padded convolution that runs in ``dtype`` (None: the input's
    type) with float32 parameters."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, k, padding=k // 2, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b,
                        padding=self.padding)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=2e-5)`` over NCHW, with
    flax's arithmetic: statistics in float32, the batch variance as
    E[x^2] - E[x]^2 clipped at 0 (flax's ``use_fast_variance``, which
    the running average takes as it is: biased), and
    y = (x - mean) * (scale * rsqrt(var + eps)) + bias."""

    def __init__(self, c: int, bias_init: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(c, eps=2e-5, momentum=0.1)
        nn.init.constant_(self.bias, bias_init)
        self.compute_dtype = dtype

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, var = (_global_batch_stats(xf) if world_size() > 1
                         else _batch_stats(xf))
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
                self.running_var.mul_(0.9).add_(var, alpha=0.1)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


def _batch_stats(xf):
    """Per-channel (mean, biased variance) of this process's batch."""
    mean = xf.mean(dim=(0, 2, 3))
    return mean, torch.relu((xf * xf).mean(dim=(0, 2, 3)) - mean * mean)


def _global_batch_stats(xf):
    """Per-channel (mean, biased variance) of the global batch, from the
    [sum x, sum x^2, count] of every rank.  The all-reduce is
    differentiable (its backward sums the ranks' gradients), so the
    gradient flows through the global statistics as it does under pjit."""
    c = xf.shape[1]
    count = xf.new_full((1,), xf.numel() // c)
    stats = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)),
                                  (xf * xf).sum(dim=(0, 2, 3)), count]))
    n = stats[2 * c]
    mean = stats[:c] / n
    return mean, torch.relu(stats[c:2 * c] / n - mean * mean)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class _SegNetBase(nn.Module):
    def _to_internal(self, x_nhwc):
        x = _nchw(x_nhwc)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def _pool(self, h, idxs, shapes):
        shapes.append(tuple(h.shape[2:]))
        p, idx = max_pool_argmax_2x2(_nhwc(h))
        idxs.append(idx)
        return _nchw(p)

    @staticmethod
    def _unpool(h, idx, out_hw):
        return _nchw(max_unpool_2x2(_nhwc(h), idx, out_hw=out_hw))


class SegNetBasic(_SegNetBase):
    """4-down/4-up SegNet-Basic (reference models/segnet_basic.py:16-78):
    64 channels, 7x7 convolutions."""

    def __init__(self, n_class: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_class = n_class
        for i in range(1, 5):
            cin = 3 if i == 1 else 64
            setattr(self, f"conv{i}", Conv(cin, 64, 7, False, dtype))
            setattr(self, f"conv{i}_bn", BatchNorm(64, 0.001, dtype))
            setattr(self, f"conv_decode{i}", Conv(64, 64, 7, False, dtype))
            setattr(self, f"conv_decode{i}_bn", BatchNorm(64, 0.001, dtype))
        self.conv_classifier = Conv(64, n_class, 1, True, dtype)

    def forward(self, x_nhwc):
        """(N, H, W, 3) float32 -> (N, H, W, n_class) scores."""
        h = local_response_normalization(x_nhwc, n=5, k=1.0,
                                         alpha=1e-4 / 5.0, beta=0.75)
        h = self._to_internal(h)
        idxs, shapes = [], []
        for i in range(1, 5):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"conv{i}_bn")
            h = self._pool(torch.relu(bn(conv(h))), idxs, shapes)
        for i in range(4, 0, -1):
            h = self._unpool(h, idxs[i - 1], shapes[i - 1])
            h = getattr(self, f"conv_decode{i}_bn")(
                getattr(self, f"conv_decode{i}")(h))
        return _nhwc(self.conv_classifier(h))


class _CBR(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__()
        self.conv = Conv(cin, cout, 3, False, dtype)
        self.bn = BatchNorm(cout, 0.0, dtype)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class _Block(nn.Sequential):
    def __init__(self, cin: int, n_cbr: int, mid: int, out: int, dtype=None):
        super().__init__()
        for i in range(n_cbr):
            cout = out if i == n_cbr - 1 else mid
            self.add_module(f"cbr{i}", _CBR(cin, cout, dtype))
            cin = cout


class SegNet(_SegNetBase):
    """VGG-style 5-down/5-up SegNet (reference models/segnet.py:47-95)."""

    ENC = [(2, 64, 64), (2, 128, 128), (3, 256, 256), (3, 512, 512),
           (3, 512, 512)]
    DEC = [(3, 512, 512), (3, 512, 256), (3, 256, 128), (2, 128, 64)]

    def __init__(self, n_class: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_class = n_class
        cin = 3
        for i, (n, mid, out) in enumerate(self.ENC, start=1):
            setattr(self, f"block{i}", _Block(cin, n, mid, out, dtype))
            cin = out
        for i, (n, mid, out) in zip(range(5, 1, -1), self.DEC):
            setattr(self, f"up_block{i}", _Block(cin, n, mid, out, dtype))
            cin = out
        self.up_block1 = _CBR(cin, 64, dtype)
        self.score = Conv(64, n_class, 3, True, dtype)

    def forward(self, x_nhwc):
        h = self._to_internal(x_nhwc)
        idxs, shapes = [], []
        for i in range(1, 6):
            h = self._pool(getattr(self, f"block{i}")(h), idxs, shapes)
        for i in range(5, 1, -1):
            h = self._unpool(h, idxs[i - 1], shapes[i - 1])
            h = getattr(self, f"up_block{i}")(h)
        h = self._unpool(h, idxs[0], shapes[0])
        return _nhwc(self.score(self.up_block1(h)))


def init_segnet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisation: he_normal convolution kernels (truncated
    normal, std sqrt(2 / fan_in) / 0.8796 cut at +-2 std), zero conv
    biases; BN scale 1 and running statistics (0, 1) as constructed."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model


SEGNETS = {"basic": SegNetBasic, "normal": SegNet}


def build_segnet(model: str = "basic", n_class: int = 2,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """SegNetBasic ('basic') or SegNet ('normal') with random weights
    from ``generator`` (seed 0 when None), on ``device`` (channels_last
    on the card), in train mode."""
    dev = resolve_device(device)
    if model not in SEGNETS:
        raise ValueError(f"unknown model {model!r}")
    with span("setup.build_segnet"):
        net = SEGNETS[model](n_class=n_class, dtype=dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        net = init_segnet_(net, generator).to(dev)
        if dev.type == "cuda":
            net = net.to(memory_format=torch.channels_last)
    return net


@torch.no_grad()
def predict_labels(model: nn.Module, images_nhwc: torch.Tensor,
                   pred_shape=None, return_score: bool = False,
                   return_small_score: bool = False):
    """Inference (reference segnet_basic.py:80-115): eval-mode forward,
    optional softmax, bilinear resize of the scores to ``pred_shape``,
    argmax over classes, on a whole batch.  Returns labels (N, H', W')
    int32 [and scores (N, H', W', C), or the (resized, pre-resize) pair
    with ``return_small_score``]."""
    was_training = model.training
    model.eval()
    try:
        score = model(images_nhwc).float()
    finally:
        model.train(was_training)
    if return_score:
        score = torch.softmax(score, dim=-1)
    small = score
    if pred_shape is not None and tuple(score.shape[1:3]) != tuple(
            pred_shape):
        score = bilinear_resize(score, pred_shape, spatial_axes=(1, 2))
    labels = score.argmax(dim=-1).to(torch.int32)
    if return_score:
        return labels, ((score, small) if return_small_score else score)
    return labels
