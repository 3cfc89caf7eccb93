"""SegNet step: 3 x the forward's convolution operations of the steps in
the traced window, from the configuration's layer table
(``counts/segnet_basic_flops.py``), over the window, the float32 peak and
the cards."""

from perfbench import peaks
from perfbench.counts import segnet_basic_flops


def read(run):
    t = run.trace
    if not t or not run.steps:
        return None
    cfg = run.cfg
    per = segnet_basic_flops.step_flops(cfg["model"], cfg["batchsize"],
                                        cfg["input_shape"])
    return (100.0 * run.steps * per / t["window_s"] / peaks.F32_FLOPS
            / run.chips)
