"""As ``device_idle_pct.label``, in the DRN-D-105 cell."""

from perfbench import harness


def read(run):
    return harness.reader("device_idle_pct.label")(run)
