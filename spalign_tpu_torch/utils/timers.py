"""The port's tracer: spans, device spans and counters, one per process;
and the per-stage timers of the records built on it.

``span(name, **ids)`` records a host interval: its name, both ends on
``time.time_ns()`` (the clock ``torch.profiler`` stamps its host events
with, so a span lies over a device trace with no offset), the thread, the
innermost span open on that thread (``parent``) and its ids (``unit=``,
``step=``; a span takes its parent's ids and adds its own).  Spans are
kept in memory in a bounded buffer (the newest ``BUFFER``).  Each carries
``traced``: whether a profiler recorded its thread when it opened; only
then does it also enter a ``torch.profiler.record_function`` of its name
(that costs ~11 us a call, the check 0.07 us).  The profiler records the
thread that started it, so the spans of other threads (the label loop's
producer) are never traced.

``device_span(name, device, stream=None, **ids)`` is a span whose device
time a CUDA event pair on the stream (default: the current one) gives.
Nothing waits for it: ``spans()`` reads ``elapsed_time`` only of the spans
whose end event has already completed, which it has once the host waited
on any later event of the stream (a unit's landing, a window's end).  On
a CPU device its device time is its host time.

``count(name, n=1)`` adds to a counter, kept apart by ``traced``.
``spans()``, ``counts()``, ``reset()`` read and clear them; ``self_ns`` is
the self time of spans.

The reference writes an elapsed_times dict into every result.json record
(batch_spalign_kmeans.py:428-458: time_superpixel, time_kmeans,
elapsed_time).  ``StageTimer`` keeps that surface: each stage is a span,
and a device stage's ``time_<name>`` is its device time, read when the
timer is read.  ``profiler_trace`` is the counterpart of the JAX
package's ``jax.profiler`` trace: a ``torch.profiler`` Chrome trace of a
region.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import Counter, deque
from typing import Dict, Iterable, Optional

import torch

BUFFER = 65536  # spans kept, the newest

_spans: deque = deque(maxlen=BUFFER)
_pending: list = []  # CUDA device spans not yet read
_counts: Counter = Counter()  # (name, traced) -> n
_lock = threading.Lock()
_local = threading.local()
_next_id = itertools.count()


def tracing() -> bool:
    """Whether a profiler records this thread."""
    return torch.autograd._profiler_enabled()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span; a context manager.  ``device_ns`` is None for a host
    span, and for a device span until its events are read."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent",
                 "ids", "traced", "device_ns", "_rf")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids
        self.device_ns = self._rf = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if parent is not None and parent.ids:
            self.ids = {**parent.ids, **self.ids}
        self.id = next(_next_id)
        self.thread = threading.get_ident()
        self.traced = torch.autograd._profiler_enabled()
        stack.append(self)
        self.start_ns = time.time_ns()
        if self.traced:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        _stack().pop()
        with _lock:
            _spans.append(self)
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class DeviceSpan(Span):
    __slots__ = ("_cuda", "_stream", "_events")

    def __init__(self, name: str, device, stream, ids: dict):
        super().__init__(name, ids)
        self._cuda = torch.device(device).type == "cuda"
        self._stream = ((stream or torch.cuda.current_stream(device))
                        if self._cuda else None)
        self._events = None

    def __enter__(self):
        super().__enter__()
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self._events = (start, None)
        return self

    def __exit__(self, *exc):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self._events = (self._events[0], end)
            self._stream = None
        super().__exit__(*exc)
        if self._cuda:
            _read_pending()
            with _lock:
                _pending.append(self)
        else:
            self.device_ns = self.ns
        return False

    def _read(self, wait: bool = False) -> bool:
        """Read the device time once the end event has completed (with
        ``wait``, wait for it first); whether it is read."""
        if self._events is None:
            return self.device_ns is not None
        start, end = self._events
        if not end.query():
            if not wait:
                return False
            end.synchronize()
        self.device_ns = int(start.elapsed_time(end) * 1e6)
        self._events = None
        return True


def _clean(ids: dict) -> dict:
    return {k: v for k, v in ids.items() if v is not None} if ids else ids


def span(name: str, **ids) -> Span:
    """A host span (module docstring)."""
    return Span(name, _clean(ids))


def device_span(name: str, device, stream=None, **ids) -> DeviceSpan:
    """A span that also takes the device time of the work enqueued in it
    on ``stream`` (default: the device's current stream)."""
    return DeviceSpan(name, device, stream, _clean(ids))


def _read_pending():
    with _lock:
        _pending[:] = [s for s in _pending if not s._read()]


def count(name: str, n: int = 1):
    """Add ``n`` to a counter."""
    key = (name, torch.autograd._profiler_enabled())
    with _lock:
        _counts[key] += n


def spans() -> list:
    """The buffered spans, in the order they ended; device spans whose end
    event has completed carry their device time."""
    _read_pending()
    with _lock:
        return list(_spans)


def counts(traced: Optional[bool] = None) -> Dict[str, int]:
    """The counters; with ``traced``, only what was counted while a
    profiler recorded the counting thread (True) or not (False)."""
    with _lock:
        items = list(_counts.items())
    out: Dict[str, int] = {}
    for (name, t), n in items:
        if traced is None or t == traced:
            out[name] = out.get(name, 0) + n
    return out


def reset():
    """Drop every span and counter."""
    with _lock:
        _spans.clear()
        _pending.clear()
        _counts.clear()


def self_ns(spans: Iterable[Span], within=None) -> Dict[int, int]:
    """Self time of each span, by id: its duration less the part of it
    that its children cover (with ``within``, a set of names: the part
    that its descendants of those names cover).  A span's children run on
    its thread, inside it."""
    spans = list(spans)
    by_id = {s.id: s for s in spans}
    covered: Dict[int, list] = {}
    for s in spans:
        if within is None:
            if s.parent in by_id:
                covered.setdefault(s.parent, []).append(s)
        elif s.name in within:
            p = s.parent
            while p in by_id:
                covered.setdefault(p, []).append(s)
                p = by_id[p].parent
    out = {}
    for s in spans:
        busy, end = 0, s.start_ns
        for c in sorted(covered.get(s.id, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, end), min(c.end_ns, s.end_ns)
            if hi > lo:
                busy += hi - lo
                end = hi
        out[s.id] = s.ns - busy
    return out


class StageTimer:
    """The records' ``time_<stage>`` seconds.  Each stage is a span named
    ``prefix + stage`` with the timer's ids."""

    def __init__(self, prefix: str = "", **ids):
        self._t0 = time.time()
        self.prefix, self.ids = prefix, _clean(ids)
        self._times: Dict[str, float] = {}
        self._device: list = []  # (stage, DeviceSpan) not yet added

    def span(self, name: str) -> Span:
        """A span named like a stage, which sums no time."""
        return Span(self.prefix + name, self.ids)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a region on the host."""
        s = Span(self.prefix + name, self.ids)
        try:
            with s:
                yield s
        finally:
            self.add(name, s.ns / 1e9)

    @contextlib.contextmanager
    def device_stage(self, name: str, device, stream=None):
        """Time the device work a region enqueues on ``stream`` (a device
        span); its seconds are added when the timer is read."""
        s = DeviceSpan(self.prefix + name, device, stream, self.ids)
        try:
            with s:
                yield s
        finally:
            self._times.setdefault(f"time_{name}", 0.0)
            self._device.append((name, s))

    def add(self, name: str, seconds: float):
        """Count ``seconds`` timed elsewhere (another thread) to a stage."""
        self._times[f"time_{name}"] = (
            self._times.get(f"time_{name}", 0.0) + seconds)

    @property
    def times(self) -> Dict[str, float]:
        """The stages' seconds.  A device stage is read here: after the
        host waited on a later event of its stream (the unit's landing)
        its events have completed; before, this waits for its end."""
        for name, s in self._device:
            s._read(wait=True)
            self.add(name, s.device_ns / 1e9)
        self._device.clear()
        return self._times

    def finish(self) -> Dict[str, float]:
        times = self.times
        times["elapsed_time"] = time.time() - self._t0
        return dict(times)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Profile the region with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) when ``log_dir`` is set, and write its
    Chrome trace as ``log_dir/trace_<pid>.json`` at the end."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
