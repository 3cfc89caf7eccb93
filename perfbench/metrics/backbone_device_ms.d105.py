"""As ``backbone_device_ms.label``, in the DRN-D-105 cell."""

from perfbench import harness


def read(run):
    return harness.reader("backbone_device_ms.label")(run)
