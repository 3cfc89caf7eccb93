"""Label device program: the share of k-means chunks (``check_every``
sweeps between two host checks) that ran as one CUDA graph replay, 100 x
the program's counters ``kmeans.replays`` over ``kmeans.chunks`` while
traced.  A program without the counters gives None."""

from perfbench import spans


def read(run):
    c = spans.traced_counts()
    if not c.get("kmeans.chunks"):
        return None
    return 100.0 * c.get("kmeans.replays", 0) / c["kmeans.chunks"]
