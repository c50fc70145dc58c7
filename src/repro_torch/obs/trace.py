"""Span tracer with Chrome trace-event export (the span part of the JAX
package's tracer).

Records nested *spans* (Chrome ``"X"`` complete events: name, start, dur)
and *instant* events into a thread-safe bounded ring buffer, exported as the
``chrome://tracing`` / Perfetto trace-event JSON format — serve
admit/prefill/decode render inside engine ticks, realize/pad/device_put/
compute inside train steps, protocol rounds as their own spans.

Properties the instrumented hot paths rely on:

  * **disabled is free** — ``span()`` on a disabled tracer returns the one
    shared :data:`NULL_SPAN` context manager (no allocation, no clock read);
  * **bounded memory** — the ring holds ``capacity`` events; overflow drops
    the *oldest* (the tail of a long run is what post-mortems need) and is
    accounted in :attr:`dropped`, never silent;
  * **thread-safe** — producer threads (prefetch) and the trainer thread
    interleave appends under one lock; timestamps share a single monotonic
    origin so cross-thread ordering in the rendered timeline is real.

Timestamps are microseconds from the origin on the tracer's clock
(``time.perf_counter``).  At :meth:`SpanTracer.reset` and
:meth:`SpanTracer.enable` the tracer reads its clock and the Unix clock
together, and :meth:`SpanTracer.export` gives the origin on the Unix clock
(``otherData.clock.origin_unix_ns``), the clock ``torch.profiler`` stamps its
events with: a span at ``ts`` began at ``origin_unix_ns + 1000 * ts``, so a
telemetry trace lays over a profiler trace of the same run.

Nesting needs no explicit parent ids: Chrome's renderer reconstructs the
span tree from ``X``-event containment per (pid, tid) track, which is
exactly what lexically nested ``with tracer.span(...)`` blocks produce.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import threading
import time

__all__ = ["NULL_SPAN", "Span", "SpanTracer", "default_tracer"]


class _NullSpan:
    """Shared no-op context manager (disabled-tracer fast path)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One live ``with``-scope; emits a single X event at exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "Span":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer.clock()
        self._tracer.complete(
            self.name, self._t0, t1 - self._t0, cat=self.cat, **self.args
        )
        return False


class SpanTracer:
    """Bounded ring buffer of Chrome trace events."""

    def __init__(
        self,
        capacity: int = 65536,
        enabled: bool = False,
        clock=time.perf_counter,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.clock = clock
        self._events: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._emitted = 0
        self._lock = threading.Lock()
        self._origin = clock()
        self._pair_clocks()
        self._tids: dict[int, int] = {}

    # -- enablement ------------------------------------------------------------
    def enable(self) -> None:
        self._pair_clocks()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- clocks ----------------------------------------------------------------
    def _pair_clocks(self) -> None:
        self._clock_pair = (self.clock(), time.time_ns())

    @property
    def origin_unix_ns(self) -> int:
        """The origin (``ts`` 0) on the Unix clock, from the latest pair."""
        t, unix_ns = self._clock_pair
        return unix_ns - round(1e9 * (t - self._origin))

    # -- recording -------------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _us(self, t: float) -> float:
        return round(1e6 * (t - self._origin), 3)

    def _append(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
            self._emitted += 1

    def span(self, name: str, cat: str = "", **args):
        """Context manager recording one complete (``X``) event on exit."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record a zero-duration marker (closure events, compile events)."""
        if not self.enabled:
            return
        event = {
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": self._us(self.clock()),
            "pid": os.getpid(),
            "tid": self._tid(),
        }
        if cat:
            event["cat"] = cat
        if args:
            event["args"] = args
        self._append(event)

    def complete(
        self, name: str, start_s: float, dur_s: float, cat: str = "", **args
    ) -> None:
        """Record an already-timed scope (start/dur on this tracer's clock)."""
        if not self.enabled:
            return
        event = {
            "name": name,
            "ph": "X",
            "ts": self._us(start_s),
            "dur": round(1e6 * dur_s, 3),
            "pid": os.getpid(),
            "tid": self._tid(),
        }
        if cat:
            event["cat"] = cat
        if args:
            event["args"] = args
        self._append(event)

    # -- views -----------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted by ring overflow (bounded memory, never silent)."""
        with self._lock:
            return self._emitted - len(self._events)

    def events(self) -> list[dict]:
        """Buffered events, oldest first (ts order per thread)."""
        with self._lock:
            return list(self._events)

    def export(self) -> dict:
        """Chrome trace-event JSON object (open in Perfetto / about:tracing)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "clock": {"origin_unix_ns": self.origin_unix_ns}},
        }

    def write(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.export(), indent=1))
        return path

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._emitted = 0
            self._origin = self.clock()
            self._pair_clocks()


_DEFAULT = SpanTracer(enabled=False)


def default_tracer() -> SpanTracer:
    """The process-wide tracer (disabled until ``--telemetry`` / tests)."""
    return _DEFAULT
