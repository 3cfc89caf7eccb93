"""Convolution operations of SegNetBasic (Badrinarayanan et al.; the
reference's models/segnet_basic.py) from its layer table: four encoder and
four decoder 7x7 convolutions of ``width`` channels, one per level at
1/2**level of the input, and the 1x1 classifier.  A train step counts
3 x the forward (forward, and the backward's two products)."""

from __future__ import annotations


def forward_flops(model: dict, batch: int, hw) -> float:
    k, c, levels = model["kernel"], model["width"], model["levels"]
    h, w = hw
    total = 0.0
    for lvl in range(levels):
        ho, wo = h >> lvl, w >> lvl
        cin = 3 if lvl == 0 else c
        total += 2 * batch * ho * wo * cin * c * k * k  # encoder
        total += 2 * batch * ho * wo * c * c * k * k  # decoder
    total += 2 * batch * h * w * c * model["n_class"]  # classifier
    return float(total)


def step_flops(model: dict, batch: int, hw) -> float:
    return 3.0 * forward_flops(model, batch, hw)
