"""The device trace of a run's window: ``torch.profiler`` (CUPTI) over the
window, reduced to what the per-layer readers take.

``Trace.summary`` gives the window's length, every device operation
(kernels, copies, fills) as (name, start, duration) in seconds from the
window's start, the seconds in which some operation ran (the union of
their intervals: ``busy_s``), the longest idle gaps named by the innermost
host operation running at the gap's middle, and the device seconds by
operation name.
"""

from __future__ import annotations

import time

import torch

WINDOW = "perfbench.window"


def _ns(e, what):
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


class Trace:
    """Profile a window: ``with Trace(on) as t:`` ... ``t.summary()``."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self._prof = None
        self._mark = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._mark = record_function(WINDOW)
            self._mark.__enter__()
        return self

    def close_window(self):
        """End the traced window (after the caller's synchronize)."""
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None

    def __exit__(self, *exc):
        self.close_window()
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def summary(self, top: int = 10) -> dict:
        t0 = time.perf_counter()
        dev, host, win = [], [], None
        cuda = torch._C._autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = _ns(e, "start"), _ns(e, "duration")
            annotation = getattr(e, "is_user_annotation", None)
            if e.device_type() == cuda:
                # the device side of a host annotation (the window's own
                # marker among them) is no operation
                if (name != WINDOW and "Sync" not in name
                        and not (annotation and annotation())):
                    dev.append((name, start, dur))
            elif name == WINDOW:
                win = (start, start + dur)
            else:
                host.append((name, start, dur))
        if win is None:
            raise RuntimeError("the trace holds no window marker")
        w0, w1 = win
        ops = []
        for name, s, d in dev:
            s2, e2 = max(s, w0), min(s + d, w1)
            if e2 > s2:
                ops.append((name, (s2 - w0) / 1e9, (e2 - s2) / 1e9))
        ops.sort(key=lambda o: o[1])
        merged = []
        for _, s, d in ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        busy = sum(e - s for s, e in merged)
        window_s = (w1 - w0) / 1e9
        edges = [0.0] + [x for iv in merged for x in iv] + [window_s]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        host_rel = [(n, (s - w0) / 1e9, d / 1e9) for n, s, d in host]
        idle = []
        for length, start in gaps:
            mid = start + length / 2
            inner = [(d, n) for n, s, d in host_rel if s <= mid <= s + d]
            idle.append([min(inner)[1][:120] if inner else "host: no op",
                         length])
        by_name = {}
        for name, _, d in ops:
            by_name[name] = by_name.get(name, 0.0) + d
        device_ops = sorted(([n[:120], s] for n, s in by_name.items()),
                            key=lambda x: -x[1])[:top]
        return {"window_s": window_s, "busy_s": busy, "ops": ops,
                "device_ops": device_ops, "idle_gaps": idle,
                "read_s": time.perf_counter() - t0}
