"""Label host loop: host milliseconds a unit spends dispatching (its
``label.dispatch`` spans, retries included, less the ``kmeans.check``
waits inside them), mean over the traced units."""

from perfbench import spans


def read(run):
    t, sp = spans.tracer(), spans.traced()
    if not sp:
        return None
    own = t.self_ns(sp, within={"kmeans.check"})
    units = spans.per_unit(sp, {"label.dispatch"}, lambda s: own[s.id])
    v = spans.mean(units.values())
    return None if v is None else v / 1e6
