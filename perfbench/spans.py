"""The program's own spans and counters (``spalign_tpu_torch.utils.
timers``) as the per-layer readers take them: those recorded while a
profiler ran.  On a traced run that is the window's, since the profiler
runs only inside ``trace.Trace``.  A program without the tracer gives
none, and its readers return None.
"""

from __future__ import annotations


def tracer():
    """The program's tracer module, or None where it has none."""
    try:
        from spalign_tpu_torch.utils import timers
    except ImportError:
        return None
    return timers if hasattr(timers, "self_ns") else None


def traced() -> list:
    t = tracer()
    return [s for s in t.spans() if s.traced] if t else []


def traced_counts() -> dict:
    t = tracer()
    return t.counts(traced=True) if t else {}


def per_unit(spans, names, value) -> dict:
    """{(pass, unit): the sum of ``value(span)`` over the spans named in
    ``names``}: a unit is numbered within its pass (a ``label.pass``
    span, found among the span's ancestors)."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        if s.name not in names or "unit" not in s.ids:
            continue
        p = s.parent
        while p in by_id and by_id[p].name != "label.pass":
            p = by_id[p].parent
        key = (p, s.ids["unit"])
        out[key] = out.get(key, 0) + value(s)
    return out


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None
