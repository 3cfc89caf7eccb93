"""Train loop: host milliseconds the benchmark's loop waits on the
program's loader (``next``) per step in the window."""


def read(run):
    if not run.waits:
        return None
    return 1e3 * sum(run.waits) / len(run.waits)
