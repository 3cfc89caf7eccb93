"""Convolution operations of a DRN-D with bottleneck blocks (Yu, Koltun &
Funkhouser 2017; DRN-D-105 at its published table) up to its stage-8
output, from the layer table in the configuration (``channels``,
``layers``, ``expansion``), not from the program's modules: 2 x the
multiply-adds of every convolution an image passes through, the skips'
1x1 convolutions included, the classifier head not.  A bottleneck's
stride sits on its 3x3 convolution, so its first 1x1 runs at the input's
size."""

from __future__ import annotations

from perfbench.counts.drn_c_26_flops import _out
from perfbench.weights_drn_d import STRIDES


def conv_table(model: dict, hw) -> list:
    """[(name, cin, cout, kernel, out_h, out_w)] of every convolution up to
    stage 8, for an (H, W) input."""
    ch, layers, exp = model["channels"], model["layers"], model["expansion"]
    h, w = hw
    rows = [("layer0.0", 3, ch[0], 7, h, w)]
    cin = ch[0]
    for s, (planes, n, stride) in enumerate(zip(ch, layers, STRIDES), 1):
        for b in range(n):
            st = stride if b == 0 else 1
            oh, ow = _out(h, st), _out(w, st)
            if s in (1, 2, 7, 8):
                rows.append((f"layer{s}.{3 * b}", cin, planes, 3, oh, ow))
                cin, h, w = planes, oh, ow
                continue
            p, wide = f"layer{s}.{b}", planes * exp
            rows += [(p + ".conv1", cin, planes, 1, h, w),
                     (p + ".conv2", planes, planes, 3, oh, ow),
                     (p + ".conv3", planes, wide, 1, oh, ow)]
            if b == 0 and (st != 1 or cin != wide):
                rows.append((p + ".downsample", cin, wide, 1, oh, ow))
            cin, h, w = wide, oh, ow
    return rows


def flops_per_image(model: dict, hw) -> float:
    return float(sum(2 * ho * wo * ci * co * k * k
                     for _, ci, co, k, ho, wo in conv_table(model, hw)))
