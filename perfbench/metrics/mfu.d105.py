"""Label device program: DRN-D-105 convolution operations of the images
labelled in the traced window, counted from the configuration's layer
table at the network input (``counts/drn_d_105_flops.py``), over the
window and the bf16 dense peak."""

from perfbench import peaks
from perfbench.counts import drn_d_105_flops


def read(run):
    t = run.trace
    if not t or not run.images:
        return None
    per = drn_d_105_flops.flops_per_image(
        run.cfg["model"], run.cfg["label_gen"]["resize_shape"])
    return 100.0 * run.images * per / t["window_s"] / peaks.BF16_FLOPS \
        / run.chips
