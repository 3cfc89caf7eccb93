"""Label device program: device milliseconds of a unit's program (its
``label.device_program`` device spans, CUDA events), mean over the
traced units."""

from perfbench import spans


def read(run):
    sp = [s for s in spans.traced() if s.device_ns is not None]
    units = spans.per_unit(sp, {"label.device_program"},
                           lambda s: s.device_ns)
    v = spans.mean(units.values())
    return None if v is None else v / 1e6
