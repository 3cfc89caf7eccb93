"""Train loop: host milliseconds the benchmark's loop waits on the
program's loader (``next``) per step in the window. Read on rank 0 of the data-parallel cell.
"""


def read(run):
    if not run.waits:
        return None
    return 1e3 * sum(run.waits) / len(run.waits)
