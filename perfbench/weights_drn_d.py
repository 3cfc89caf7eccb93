"""The parameter names and shapes of a DRN-D (Yu, Koltun & Funkhouser
2017) with bottleneck blocks, from the configuration's layer table, for
``weights.make``: the D stem (stages 1-2 and 7-8 plain conv-BN-ReLU
layers, ``layer0`` the 7x7 stem), bottlenecks of ``expansion`` in stages
3-6, the names of the published checkpoints (``layer0.0.weight``,
``layer5.3.conv2.weight``, ``layer3.0.downsample.1.running_var``)."""

from __future__ import annotations

STRIDES = (1, 2, 2, 2, 1, 1, 1, 1)  # of stages 1..8


def drn_d_shapes(model: dict) -> list:
    """[(name, shape, or the channels of a BN)] of the configuration's
    ``channels``, ``layers``, ``expansion`` and ``num_classes``."""
    ch, layers, exp = model["channels"], model["layers"], model["expansion"]
    out = [("layer0.0", (ch[0], 3, 7, 7)), ("layer0.1", ch[0])]
    cin = ch[0]
    for s, (planes, n, stride) in enumerate(zip(ch, layers, STRIDES), 1):
        for b in range(n):
            if s in (1, 2, 7, 8):  # conv, BN, ReLU: indices 3b, 3b + 1
                out += [(f"layer{s}.{3 * b}", (planes, cin, 3, 3)),
                        (f"layer{s}.{3 * b + 1}", planes)]
                cin = planes
                continue
            p, wide = f"layer{s}.{b}", planes * exp
            out += [(p + ".conv1", (planes, cin, 1, 1)), (p + ".bn1", planes),
                    (p + ".conv2", (planes, planes, 3, 3)),
                    (p + ".bn2", planes),
                    (p + ".conv3", (wide, planes, 1, 1)), (p + ".bn3", wide)]
            if b == 0 and (stride != 1 or cin != wide):
                out += [(p + ".downsample.0", (wide, cin, 1, 1)),
                        (p + ".downsample.1", wide)]
            cin = wide
    out.append(("fc", (model["num_classes"], cin, 1, 1)))
    return out
