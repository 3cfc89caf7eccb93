"""Label device program: k-means sweeps a clustering group, from the
program's counters ``kmeans.sweeps`` over ``kmeans.groups`` (every try's
landed sweep counts) while traced."""

from perfbench import spans


def read(run):
    c = spans.traced_counts()
    if not c.get("kmeans.groups"):
        return None
    return c["kmeans.sweeps"] / c["kmeans.groups"]
