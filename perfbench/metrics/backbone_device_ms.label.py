"""DRN backbone: device milliseconds of a unit's backbone (its
``label.features`` device spans, CUDA events from the first enqueue to the
last kernel: busy and idle alike), mean over the traced units.  A program
whose ``label.features`` is a host span gives None."""

from perfbench import spans


def read(run):
    sp = [s for s in spans.traced() if s.device_ns is not None]
    units = spans.per_unit(sp, {"label.features"}, lambda s: s.device_ns)
    v = spans.mean(units.values())
    return None if v is None else v / 1e6
