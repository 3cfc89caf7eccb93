"""Label device program: the share of units whose program up to the
k-means loop ran as CUDA graph replays, 100 x the program's counters
``label.unit_replays`` over ``label.units`` while traced.  A program
without the counters gives None."""

from perfbench import spans


def read(run):
    c = spans.traced_counts()
    if not c.get("label.units"):
        return None
    return 100.0 * c.get("label.unit_replays", 0) / c["label.units"]
