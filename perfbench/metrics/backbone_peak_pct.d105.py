"""DRN backbone: its share of the bf16 dense peak, which is its roofline
(the convolutions are bound by operations): 100 x the DRN-D-105
convolution operations of the images through the backbone while traced
(the program's counter ``drn.images``, the layer table's count an image,
``counts/drn_d_105_flops.py``) over their ``label.features`` device time
(CUDA events, busy and idle alike, so never over 100) and the peak.  A
program without the counter or the device span gives None."""

from perfbench import peaks, spans
from perfbench.counts import drn_d_105_flops


def read(run):
    images = spans.traced_counts().get("drn.images")
    ns = sum(s.device_ns for s in spans.traced()
             if s.name == "label.features" and s.device_ns is not None)
    if not images or ns <= 0:
        return None
    per = drn_d_105_flops.flops_per_image(
        run.cfg["model"], run.cfg["label_gen"]["resize_shape"])
    return 100.0 * images * per / (ns / 1e9) / peaks.BF16_FLOPS
