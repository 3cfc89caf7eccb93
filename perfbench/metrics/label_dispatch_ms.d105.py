"""As ``label_dispatch_ms``, in the DRN-D-105 cell."""

from perfbench import harness


def read(run):
    return harness.reader("label_dispatch_ms")(run)
