"""The traced run's reduction: ``torch.profiler`` over a few whole steps of
the window, with the port's own tracer on.

The profiler is started and stopped at step boundaries (the trainer syncs
the card at the end of every step while its tracer is on).  A marker range
at each boundary ties the profiler's clock to the host's
``time.perf_counter``, so the trainer's spans, which that clock times, can
name what the host was doing in each idle gap of the card.  Device events
are every kernel, copy and set on the card; their union over the profiled
window is the busy time.
"""

from __future__ import annotations

import time

MARK = "odb_bench.boundary"


def mark() -> int:
    """Record a boundary marker; returns the host clock in ns."""
    import torch

    now = time.perf_counter_ns()
    with torch.profiler.record_function(MARK):
        pass
    return now


class Profile:
    """Device events of the profiled window, and the host ops that launched
    them."""

    def __init__(self, events, host_marks_ns: list, steps: int):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        marks = sorted(e.start_ns() for e in events
                       if e.name() == MARK and e.device_type() != cuda)
        self.offset_ns = marks[0] - host_marks_ns[0] if marks else 0
        self.start_ns, self.end_ns = (marks[0], marks[-1]) if marks else (0, 0)
        self.steps = steps
        self.device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.linked_correlation_id())
                       for e in events
                       if e.device_type() == cuda and not e.name().startswith(MARK)
                       and self.start_ns <= e.start_ns() <= self.end_ns]
        self.host = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(), e.correlation_id())
                     for e in events if e.device_type() != cuda]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        merged: list = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self, match=None) -> list:
        return [d for d in self.device if match is None or match(d[0])]

    def device_s(self, match=None) -> float:
        return sum(e - s for _, s, e, _ in self.kernels(match)) / 1e9

    def device_s_under(self, range_name: str) -> float:
        """Device seconds of the kernels whose launching host op ran inside a
        host range of this name (on the op's thread)."""
        ranges: dict = {}
        ops = {}
        for name, s, e, tid, corr in self.host:
            if name == range_name:
                ranges.setdefault(tid, []).append((s, e))
            else:
                ops[corr] = (tid, s)
        total = 0
        for _, s, e, linked in self.device:
            op = ops.get(linked)
            if op and any(a <= op[1] <= b for a, b in ranges.get(op[0], ())):
                total += e - s
        return total / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e, _ in self.device:
            by[name] = by.get(name, 0) + (e - s)
        return [[name[:120], ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: list, n: int = 10, named: int = 2000) -> list:
        """Idle time of the card summed by what the host was doing: the
        innermost trainer span (``spans`` = (name, start_s, end_s) on the
        host clock) at each gap's middle and, for the ``named`` longest
        gaps, the outermost host op there."""
        import numpy as np

        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = sorted(((e - s, s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s), reverse=True)
        host = [h for h in self.host if h[0] != MARK]
        starts = np.array([h[1] for h in host], dtype=np.int64)
        ends = np.array([h[2] for h in host], dtype=np.int64)
        by: dict = {}
        for rank, (length, s, e) in enumerate(gaps):
            mid = (s + e) // 2
            host_s = (mid - self.offset_ns) / 1e9
            inside = [sp for sp in spans if sp[1] <= host_s <= sp[2]]
            name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "outside trainer spans"
            if rank < named and len(host):
                hits = np.flatnonzero((starts <= mid) & (ends >= mid))
                if len(hits):
                    name += " | " + host[int(hits[np.argmin(starts[hits])])][0][:80]
            by[name] = by.get(name, 0) + length
        return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
