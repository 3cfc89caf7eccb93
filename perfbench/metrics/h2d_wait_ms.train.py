"""Train loop: host milliseconds of a step's copy to the device (the
``train.h2d`` span around ``Trainer.to_device``), mean over the traced
steps."""

from perfbench import spans


def read(run):
    v = spans.mean(s.ns for s in spans.traced() if s.name == "train.h2d")
    return None if v is None else v / 1e6
