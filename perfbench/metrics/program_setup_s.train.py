"""SegNet step: seconds of set-up in the program's own spans,
``setup.build_segnet`` and ``setup.trainer`` (the outermost of them; a
trainer that builds its model holds the build)."""

from perfbench import spans


def read(run):
    t = spans.tracer()
    if t is None:
        return None
    sp = [s for s in t.spans() if s.name.startswith("setup.")]
    ids = {s.id for s in sp}
    top = [s.ns for s in sp if s.parent not in ids]
    return sum(top) / 1e9 if top else None
