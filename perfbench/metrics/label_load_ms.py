"""Label host loop: milliseconds a unit spends loading (the producer
thread's ``time_load`` in the records, per unit), mean over the units that
landed in the window."""


def read(run):
    loads = [u["time_load"] for u in run.units if u["time_load"] is not None]
    return 1e3 * sum(loads) / len(loads) if loads else None
