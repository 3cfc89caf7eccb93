"""Dilated Residual Networks (DRN-C / DRN-D) as PyTorch modules.

Counterpart of ``spalign_tpu/models/drn.py`` (Yu, Koltun & Funkhouser,
CVPR 2017).  The module and parameter names follow the public pretrained
checkpoints (``layer3.0.conv1.weight``, ``layer3.0.downsample.0.weight``),
so such a state_dict loads as it is.  Public layouts stay the JAX
package's: images NHWC, and ``forward`` returns ``(out, maps)`` with the
eight stage outputs NHWC.  Inside, the convolutions run NCHW (or
``channels_last`` on the card, which is NHWC in memory).

The label path reads stage 8's output: for a 224x224 input, a 512-channel
28x28 map (output stride 8, map index 7).

``fold_drn`` makes the inference form the label path runs on the card,
``FoldedDRN``: each eval BatchNorm folded into the convolution before it,
and each convolution output through one in-place epilogue (bias, residual,
ReLU: ``kernels/drn_epilogue.py``).  ``DRN`` itself keeps its BN.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
from torch import nn

from spalign_tpu_torch.kernels.drn_epilogue import drn_epilogue
from spalign_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def imagenet_stats(device: torch.device):
    """(mean (3,), std (3,)) float32 on ``device``, built once a device:
    a copy from host memory would wait for the device's queued work on
    every call."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def preprocess_imagenet(x_rgb_0_255: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 255] -> normalized float32
    (reference models/drn.py:304-321 batch_predict)."""
    x = x_rgb_0_255.to(torch.float32) / 255.0
    mean, std = imagenet_stats(x.device)
    return (x - mean) / std


def _conv3(cin, cout, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation,
                     dilation=dilation, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=None,
                 dilation=(1, 1), residual=True):
        super().__init__()
        self.conv1 = _conv3(cin, planes, stride, dilation[0])
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3(planes, planes, 1, dilation[1])
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample
        self.residual = residual

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.residual:
            y = y + (x if self.downsample is None else self.downsample(x))
        return torch.relu(y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=None,
                 dilation=(1, 1), residual=True):
        super().__init__()
        del residual  # bottlenecks always add the skip (reference :86-106)
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation[1], dilation=dilation[1],
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + r)


class DRN(nn.Module):
    """8-stage dilated residual network.

    ``forward`` takes NHWC images already preprocessed
    (:func:`preprocess_imagenet`) and returns (head output NHWC, the 8
    stage outputs NHWC); ``features`` returns the concatenation of the
    chosen stage outputs and skips the head."""

    def __init__(self, block, layers: Sequence[int],
                 channels=(16, 32, 64, 128, 256, 512, 512, 512),
                 num_classes: int = 1000, arch: str = "C"):
        super().__init__()
        if arch not in ("C", "D"):
            raise ValueError(f"unknown arch {arch!r}")
        self.arch = arch
        self.inplanes = channels[0]
        if arch == "C":
            self.conv1 = nn.Conv2d(3, channels[0], 7, padding=3, bias=False)
            self.bn1 = nn.BatchNorm2d(channels[0])
            self.layer1 = self._res(BasicBlock, channels[0], layers[0])
            self.layer2 = self._res(BasicBlock, channels[1], layers[1],
                                    stride=2)
        else:
            self.layer0 = nn.Sequential(
                nn.Conv2d(3, channels[0], 7, padding=3, bias=False),
                nn.BatchNorm2d(channels[0]), nn.ReLU(inplace=True))
            self.layer1 = self._convs(channels[0], layers[0])
            self.layer2 = self._convs(channels[1], layers[1], stride=2)
        self.layer3 = self._res(block, channels[2], layers[2], stride=2)
        self.layer4 = self._res(block, channels[3], layers[3], stride=2)
        self.layer5 = self._res(block, channels[4], layers[4], dilation=2,
                                new_level=False)
        self.layer6 = (self._res(block, channels[5], layers[5], dilation=4,
                                 new_level=False) if layers[5] else None)
        if arch == "C":
            self.layer7 = (self._res(BasicBlock, channels[6], layers[6],
                                     dilation=2, new_level=False,
                                     residual=False) if layers[6] else None)
            self.layer8 = (self._res(BasicBlock, channels[7], layers[7],
                                     new_level=False, residual=False)
                           if layers[7] else None)
        else:
            self.layer7 = (self._convs(channels[6], layers[6], dilation=2)
                           if layers[6] else None)
            self.layer8 = (self._convs(channels[7], layers[7])
                           if layers[7] else None)
        self.fc = (nn.Conv2d(self.inplanes, num_classes, 1)
                   if num_classes > 0 else None)

    def _res(self, block, planes, n, stride=1, dilation=1, new_level=True,
             residual=True):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias=False),
                nn.BatchNorm2d(planes * block.expansion))
        if dilation == 1:
            first = (1, 1)
        else:
            first = ((dilation // 2 if new_level else dilation), dilation)
        blocks = [block(self.inplanes, planes, stride, downsample, first,
                        residual)]
        self.inplanes = planes * block.expansion
        for _ in range(1, n):
            blocks.append(block(self.inplanes, planes,
                                dilation=(dilation, dilation),
                                residual=residual))
        return nn.Sequential(*blocks)

    def _convs(self, channels, n, stride=1, dilation=1):
        mods = []
        for i in range(n):
            mods += [nn.Conv2d(self.inplanes, channels, 3,
                               stride=stride if i == 0 else 1,
                               padding=dilation, dilation=dilation,
                               bias=False),
                     nn.BatchNorm2d(channels), nn.ReLU(inplace=True)]
            self.inplanes = channels
        return nn.Sequential(*mods)

    def _stages(self, x_nchw):
        if self.arch == "C":
            x = torch.relu(self.bn1(self.conv1(x_nchw)))
        else:
            x = self.layer0(x_nchw)
        maps = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4,
                      self.layer5, self.layer6, self.layer7, self.layer8):
            if layer is not None:
                x = layer(x)
                maps.append(x)
        return x, maps

    def _to_internal(self, x_nhwc):
        p = next(self.parameters())
        x = x_nhwc.permute(0, 3, 1, 2).to(p.dtype)
        if p.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def forward(self, x_nhwc):
        x, maps = self._stages(self._to_internal(x_nhwc))
        out = x if self.fc is None else self.fc(x)
        return (out.permute(0, 2, 3, 1),
                tuple(m.permute(0, 2, 3, 1) for m in maps))

    def features(self, x_nhwc, use_maps=(7,)) -> torch.Tensor:
        """(B, H, W, 3) preprocessed -> (B, hf, wf, C) float32, the
        concatenated stage outputs ``use_maps``."""
        _, maps = self._stages(self._to_internal(x_nhwc))
        cat = torch.cat([maps[i] for i in use_maps], dim=1)
        return cat.permute(0, 2, 3, 1).to(torch.float32).contiguous()


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype):
    """``conv`` then eval ``bn`` as one convolution: (a bias-free
    ``nn.Conv2d`` whose weight is W * s rounded once to ``dtype``, the
    float32 shift beta - mean * s), s = gamma / sqrt(var + eps) per output
    channel, all in float32 on the CPU."""
    with torch.no_grad():
        s = (bn.weight.float()
             / torch.sqrt(bn.running_var.float() + bn.eps)).cpu()
        weight = conv.weight.float().cpu() * s.reshape(-1, 1, 1, 1)
        shift = bn.bias.float().cpu() - bn.running_mean.float().cpu() * s
    folded = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                       stride=conv.stride, padding=conv.padding,
                       dilation=conv.dilation, groups=conv.groups,
                       bias=False, device="meta")
    folded.weight = nn.Parameter(weight.to(dtype), requires_grad=False)
    return folded, shift


class _FoldedConvReLU(nn.Module):
    """Convolution, eval BN, ReLU (a C stem, a D stem, a stage of
    ``DRN._convs``): the folded convolution and the ReLU epilogue."""

    def __init__(self, conv, bn, dtype):
        super().__init__()
        self.conv, shift = _fold(conv, bn, dtype)
        self.register_buffer("shift", shift)

    def forward(self, x):
        return drn_epilogue(self.conv(x), self.shift)


class _FoldedBlock(nn.Module):
    """A ``BasicBlock`` or ``Bottleneck``: every convolution but the last
    through the ReLU epilogue; the last one's epilogue adds the skip, the
    input or the downsample convolution's output, when the block adds one.
    The downsample convolution has no epilogue of its own: its BN shift
    joins the last one's, relu(W3 h + Wd x + (b3 + bd))."""

    def __init__(self, block, dtype):
        super().__init__()
        pairs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
        if isinstance(block, Bottleneck):
            pairs.append((block.conv3, block.bn3))
        self.inner = nn.ModuleList(_FoldedConvReLU(c, b, dtype)
                                   for c, b in pairs[:-1])
        self.conv, shift = _fold(*pairs[-1], dtype)
        # bottlenecks always add the skip; a basic block when ``residual``
        self.residual = getattr(block, "residual", True)
        self.down = None
        if self.residual and block.downsample is not None:
            self.down, down_shift = _fold(*block.downsample, dtype)
            shift = shift + down_shift
        self.register_buffer("shift", shift)

    def forward(self, x):
        y = x
        for f in self.inner:
            y = f(y)
        skip = None
        if self.residual:
            skip = x if self.down is None else self.down(x)
        return drn_epilogue(self.conv(y), self.shift, skip)


def _fold_stage(layer: nn.Sequential, dtype) -> nn.Sequential:
    """One of ``DRN``'s stages folded: blocks (``DRN._res``) or
    convolution, BN, ReLU triples (``DRN._convs``)."""
    if isinstance(layer[0], nn.Conv2d):
        return nn.Sequential(*(_FoldedConvReLU(layer[i], layer[i + 1], dtype)
                               for i in range(0, len(layer), 3)))
    return nn.Sequential(*(_FoldedBlock(b, dtype) for b in layer))


class FoldedDRN(nn.Module):
    """A ``DRN``'s ``features`` for inference, eval BN folded into the
    convolutions (``fold_drn``).  Its weights are in the compute dtype,
    its shifts float32: move it with ``.to(device)`` and
    ``.to(memory_format=...)``, never ``.to(dtype)`` (fold again)."""

    def __init__(self, model: DRN, dtype: torch.dtype):
        super().__init__()
        if model.arch == "C":
            self.stem = _FoldedConvReLU(model.conv1, model.bn1, dtype)
        else:
            conv, bn, _ = model.layer0
            self.stem = _FoldedConvReLU(conv, bn, dtype)
        self.stages = nn.ModuleList(
            _fold_stage(layer, dtype)
            for layer in (model.layer1, model.layer2, model.layer3,
                          model.layer4, model.layer5, model.layer6,
                          model.layer7, model.layer8) if layer is not None)

    @torch.no_grad()
    def features(self, x_nhwc, use_maps=(7,)) -> torch.Tensor:
        """``DRN.features``: (B, H, W, 3) preprocessed -> (B, hf, wf, C)
        float32, the concatenated stage outputs ``use_maps``."""
        w = self.stem.conv.weight
        x = x_nhwc.permute(0, 3, 1, 2).to(w.dtype)
        if w.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.stem(x)
        maps = []
        for stage in self.stages:
            x = stage(x)
            maps.append(x)
        cat = torch.cat([maps[i] for i in use_maps], dim=1)
        return cat.permute(0, 2, 3, 1).to(torch.float32).contiguous()


def fold_drn(model: DRN, dtype: torch.dtype = torch.float32) -> FoldedDRN:
    """The inference form of ``model`` (its eval BN statistics folded in
    float32, the weights rounded once to ``dtype``), on the CPU; ``model``
    is left as it is."""
    return FoldedDRN(model, dtype).eval()


def init_drn_(model: DRN, generator: torch.Generator) -> DRN:
    """Random weights drawn from ``generator``: convolutions
    lecun-normal (std 1/sqrt(fan_in), flax's default), batch norms at
    identity (scale 1, shift 0, mean 0, var 1), head bias 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(fan_in),
                                generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def _factory(block, layers, arch):
    def build(num_classes: int = 1000, device="cuda",
              generator: Optional[torch.Generator] = None) -> DRN:
        dev = resolve_device(device)
        model = DRN(block, layers, num_classes=num_classes, arch=arch)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return init_drn_(model, generator).to(dev).eval()

    return build


drn_c_26 = _factory(BasicBlock, (1, 1, 2, 2, 2, 2, 1, 1), "C")
drn_c_42 = _factory(BasicBlock, (1, 1, 3, 4, 6, 3, 1, 1), "C")
drn_c_58 = _factory(Bottleneck, (1, 1, 3, 4, 6, 3, 1, 1), "C")
drn_d_22 = _factory(BasicBlock, (1, 1, 2, 2, 2, 2, 1, 1), "D")
drn_d_38 = _factory(BasicBlock, (1, 1, 3, 4, 6, 3, 1, 1), "D")
drn_d_54 = _factory(Bottleneck, (1, 1, 3, 4, 6, 3, 1, 1), "D")
drn_d_105 = _factory(Bottleneck, (1, 1, 3, 4, 23, 3, 1, 1), "D")

def batch_predict(model: DRN, images_rgb_0_255: torch.Tensor,
                  train: bool = False):
    """Reference-API convenience (models/drn.py:304-325 batch_predict):
    (B, H, W, 3) RGB in [0, 255], NHWC on the model's device ->
    (head_output (B, h, w, classes), middle_maps: the eight stage
    outputs (B, h_i, w_i, C_i)), all NHWC as ``DRN.forward`` returns
    them, with the ImageNet normalisation applied inside.  ``train``
    runs the batch norms on the batch's statistics (and updates their
    running averages); the model is left in the mode it was in."""
    was_training = model.training
    model.train(train)
    try:
        with torch.set_grad_enabled(train):
            return model(preprocess_imagenet(images_rgb_0_255))
    finally:
        model.train(was_training)


def predict(model: DRN, image_rgb_0_255: torch.Tensor):
    """Per-image convenience (reference models/drn.py:287-302 predict):
    one (H, W, 3) RGB [0, 255] image -> ``batch_predict``'s (head_output,
    middle_maps) of the batch of one, NHWC, in eval mode."""
    return batch_predict(model, image_rgb_0_255[None], train=False)


DRN_FACTORIES = {
    "drn_c_26": drn_c_26, "drn_c_42": drn_c_42, "drn_c_58": drn_c_58,
    "drn_d_22": drn_d_22, "drn_d_38": drn_d_38, "drn_d_54": drn_d_54,
    "drn_d_105": drn_d_105,
}
