"""CUDA graphs: the one place in the port that captures and replays them.

``Captured`` runs a program of stages over static copies of its inputs:
one eager warm run on a side stream keeps lazy initialisation (cuDNN and
cuBLAS handles, kernel builds, cached constants) out of the graphs, then
the stages are captured back to back into one memory pool in
``thread_local`` mode, so that other threads (the label loop's producer)
go on uploading.  Capture neither synchronizes the card nor empties the
allocator's caches.  ``GraphCache`` keeps the newest few by the caller's
key.  A graph holds the address of everything it reads, weights
included, so their owner owns the cache; an entry serves one thread at a
time.
"""

from __future__ import annotations

from collections import OrderedDict

import torch


def _tensors(value):
    """The tensors of a buffer: one tensor or a tuple of them."""
    return value if isinstance(value, tuple) else (value,)


def capture(stages, bufs: dict, counted):
    """Warm-run ``stages`` on a side stream, then capture each into one
    pool; what each returns goes into ``bufs``.  Returns the graphs and
    the launches each stage's warm run added to each of ``counted``."""
    dev = _tensors(next(iter(bufs.values())))[0].device
    graphs, launches, pool = [], [], None
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for stage in stages:
                before = [f.launches for f in counted]
                bufs.update(stage(bufs))
                launches.append([f.launches - n
                                 for f, n in zip(counted, before)])
            after = [f.launches for f in counted]
            for stage in stages:
                graphs.append(torch.cuda.CUDAGraph())
                graphs[-1].capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    bufs.update(stage(bufs))
                finally:
                    graphs[-1].capture_end()
                pool = graphs[-1].pool()
        for f, n in zip(counted, after):
            f.launches = n  # a capture runs nothing
        torch.cuda.current_stream().wait_stream(side)
    return graphs, launches


class Captured:
    """``stages`` over static copies of ``inputs`` (name -> a tensor or a
    tuple of tensors) as CUDA graphs.  A stage takes ``bufs``, the static
    inputs and the buffers of the stages before it, and returns a dict of
    its own buffers, which each replay of its graph rewrites.
    ``counted``: kernel wrappers with a ``launches`` count that the
    stages call; a replay adds what its stage's warm run added."""

    def __init__(self, stages, inputs: dict, counted):
        self.bufs = {name: tuple(t.clone() for t in _tensors(value))
                     if isinstance(value, tuple) else value.clone()
                     for name, value in inputs.items()}
        self.counted = counted
        self.graphs, self.launches = capture(stages, self.bufs, counted)

    def load(self, **named):
        """Copy tensors into the static buffers of these names (a buffer
        given as itself stays)."""
        for name, value in named.items():
            for dst, src in zip(_tensors(self.bufs[name]), _tensors(value)):
                if dst is not src:
                    dst.copy_(src)

    def replay(self, stage: int):
        self.graphs[stage].replay()
        for f, n in zip(self.counted, self.launches[stage]):
            f.launches += n


class GraphCache:
    """The newest ``bound`` ``Captured`` programs by the caller's key."""

    def __init__(self, bound: int, *, counted):
        self.bound, self.counted = bound, counted
        self.entries: "OrderedDict[object, Captured]" = OrderedDict()

    def load(self, key, stages, inputs: dict) -> Captured:
        """The program of ``key`` (``stages`` captured on its first use),
        holding ``inputs``."""
        entry = self.entries.pop(key, None)
        if entry is None:
            entry = Captured(stages, inputs, self.counted)
        entry.load(**inputs)
        self.entries[key] = entry
        while len(self.entries) > self.bound:
            self.entries.popitem(last=False)
        return entry

    def __len__(self):
        return len(self.entries)
