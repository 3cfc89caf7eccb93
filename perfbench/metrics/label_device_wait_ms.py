"""Label host loop: host milliseconds a unit waits on the card (its
``kmeans.check`` reads and its ``label.land`` waits), mean over the
traced units that landed."""

from perfbench import spans


def read(run):
    sp = spans.traced()
    landed = spans.per_unit(sp, {"label.land"}, lambda s: s.ns)
    if not landed:
        return None
    checks = spans.per_unit(sp, {"kmeans.check"}, lambda s: s.ns)
    return spans.mean(v + checks.get(k, 0) for k, v in landed.items()) / 1e6
