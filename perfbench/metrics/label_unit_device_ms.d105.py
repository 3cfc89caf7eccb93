"""As ``label_unit_device_ms``, in the DRN-D-105 cell."""

from perfbench import harness


def read(run):
    return harness.reader("label_unit_device_ms")(run)
