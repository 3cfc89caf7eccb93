"""Label host loop: milliseconds a unit spends in the native scorer (the
records' ``time_score``, per unit), mean over the units that landed."""


def read(run):
    scores = [u["time_score"] for u in run.units
              if u["time_score"] is not None]
    return 1e3 * sum(scores) / len(scores) if scores else None
