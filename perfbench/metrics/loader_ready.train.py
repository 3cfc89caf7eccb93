"""Train loop: batches ready in the loader's queue when the step takes
one (the program's counters ``loader.ready`` over ``loader.takes``)
while traced."""

from perfbench import spans


def read(run):
    c = spans.traced_counts()
    if not c.get("loader.takes"):
        return None
    return c["loader.ready"] / c["loader.takes"]
