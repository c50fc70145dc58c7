"""Background-thread prefetcher with bounded-queue backpressure (DESIGN.md §9.3).

Overlaps the data-side work of the streaming path — pipeline realization,
grouping, alignment rounds, bucket padding — with the consumer's train
step.  A producer thread drains the step iterator into a bounded
``queue.Queue``; ``put`` blocks when the consumer falls behind (backpressure:
the producer can never run more than ``depth`` steps ahead, which also caps
host memory for staged batches), and ``get`` blocks when the producer is
behind (a *miss*, i.e. the train step would have stalled on data anyway).

The hit/miss split is the prefetcher's figure of merit: a hit means the next
batch was already staged when the consumer asked — at steady state with
compute-bound steps, the hit rate should approach 1.0 (chip_smoke.py prints
it for the training runs on the card).

Threading notes: producer exceptions are captured and re-raised in the
consumer thread at the position they occurred; ``close()`` signals a
condition the producer waits on, so a producer blocked on a full queue wakes
*immediately* (no put-poll, no timing-dependent spin) and ``close()`` returns
as soon as the producer's current item finishes.  The GIL makes the
protocol/bookkeeping overlap cooperative rather than parallel on pure-Python
stages; ``stream/workers.py`` moves the heavy stages into worker processes
(DESIGN.md §14) and this iterator then carries already-realized steps, with
its ``stage`` hook as the producer-side staging point (pinned host
copies issued on a CUDA stream, ``OnlineDynamicLoader._stage_device``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Generic, Iterable, Iterator, TypeVar

from repro_torch import obs

T = TypeVar("T")

_END = object()


class _ClosableQueue:
    """Bounded FIFO whose blocked producers/consumers wake on ``close()``.

    ``queue.Queue`` offers no close signal: a producer blocked in ``put`` on
    a full queue can only poll with a timeout (the old 0.05 s spin).  Here
    both sides wait on one condition; ``close()`` flips the flag under the
    lock and notifies everyone, so shutdown latency is lock-handoff time,
    not a poll interval.
    """

    def __init__(self, maxsize: int) -> None:
        self._maxsize = maxsize
        self._items: list = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.closed = False

    def put(self, item, force: bool = False) -> bool:
        """Block until space or close; False = queue closed, item dropped.

        ``force=True`` appends even when full (never blocks) — reserved for
        the terminal sentinel: a producer that just *failed* must be able to
        deliver ``_END`` past a full queue, or the error it captured would
        sit unreported behind a blocked put until the consumer happened to
        drain (tests/test_stream.py::TestPrefetch).
        """
        with self._cond:
            while not force and len(self._items) >= self._maxsize and not self.closed:
                self._cond.wait()
            if self.closed:
                return False
            self._items.append(item)
            self._cond.notify_all()
            return True

    def get(self, timeout: float | None = None):
        """Pop the head; raises ``queue.Empty`` on timeout (or when closed
        with nothing buffered).  ``timeout=0`` = non-blocking."""
        with self._cond:
            if not self._items and timeout != 0 and not self.closed:
                self._cond.wait_for(lambda: self._items or self.closed, timeout)
            if not self._items:
                raise queue.Empty
            item = self._items.pop(0)
            self._cond.notify_all()
            return item

    def qsize(self) -> int:
        with self._lock:
            return len(self._items)

    def close(self) -> None:
        """Discard buffered items and wake every waiter immediately."""
        with self._cond:
            self.closed = True
            self._items.clear()
            self._cond.notify_all()


@dataclasses.dataclass
class PrefetchStats:
    produced: int = 0  # items the producer finished staging
    consumed: int = 0  # items delivered to the consumer
    hits: int = 0  # get() satisfied without blocking
    misses: int = 0  # consumer had to wait on the producer
    wait_s: float = 0.0  # total consumer stall time
    produce_s: float = 0.0  # total producer-side staging time

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class PrefetchIterator(Generic[T]):
    """Iterate ``source`` through a ``depth``-bounded background queue.

    ``stage`` is an optional producer-side hook applied to every item before
    it is queued (timed into ``produce_s``).  The loader uses it to issue
    the host-to-card copies of the staged ``DeviceBatch`` arrays on a CUDA
    stream of its own, so the H2D transfer hides under the consumer's step:
    by the time the consumer dequeues, the copies are issued and carry the
    event its stream waits on (double-buffered by the queue depth).
    """

    def __init__(
        self, source: Iterable[T], *, depth: int = 2, stage=None
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self._stage = stage
        self.stats = PrefetchStats()
        # Telemetry (DESIGN.md §13): hit/miss split + queue depth + stall time.
        self._m_hits = obs.counter(
            "odb_prefetch_hits_total", help="get() satisfied without blocking"
        )
        self._m_misses = obs.counter(
            "odb_prefetch_misses_total", help="consumer waited on the producer"
        )
        self._m_wait = obs.counter(
            "odb_prefetch_wait_seconds_total",
            help="total consumer stall time",
            unit="seconds",
        )
        self._m_depth = obs.gauge(
            "odb_prefetch_queue_depth", help="staged items at last delivery"
        )
        self._queue = _ClosableQueue(depth)
        self._stop = threading.Event()
        self._finished = False  # _END consumed, error raised, or closed
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True
        )
        self._thread.start()

    # -- producer side ---------------------------------------------------------
    def _produce(self, it: Iterator[T]) -> None:
        try:
            tracer = obs.default_tracer()
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                if self._stage is not None:
                    item = self._stage(item)
                dt = time.perf_counter() - t0
                self.stats.produce_s += dt
                tracer.complete(
                    "prefetch/produce", t0, dt, cat="prefetch",
                    item=self.stats.produced,
                )
                # Blocks on a full queue; a close() wakes it immediately
                # (Event-signaled, not put-polled) and returns False.
                if not self._queue.put(item):
                    return
                self.stats.produced += 1
        except BaseException as exc:  # surfaced on the consumer side
            self._error = exc
        # force: the sentinel must land even on a full queue — on the error
        # path nothing will ever drain ahead of it if the consumer is slow,
        # and the producer thread must exit promptly either way.
        self._queue.put(_END, force=True)

    # -- consumer side ---------------------------------------------------------
    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        if self._finished:
            raise StopIteration
        try:
            item = self._queue.get(timeout=0)
            hit = True
        except queue.Empty:
            hit = False
            t0 = time.perf_counter()
            while True:
                try:
                    item = self._queue.get(timeout=0.1)
                    break
                except queue.Empty:
                    # Producer dead with nothing queued (e.g. close() drained
                    # the sentinel): the stream is over, don't block forever —
                    # but never swallow a captured producer error into a bare
                    # StopIteration (the pre-fix masking bug).
                    if self._finished or not self._thread.is_alive():
                        self._finished = True
                        if self._error is not None:
                            error, self._error = self._error, None
                            raise error
                        raise StopIteration from None
            waited = time.perf_counter() - t0
            self.stats.wait_s += waited
            self._m_wait.inc(waited)
            obs.default_tracer().complete(
                "prefetch/wait", t0, waited, cat="prefetch"
            )
        if item is _END:
            # The terminal sentinel is not a data request; don't score it.
            self._finished = True
            self._thread.join(timeout=5.0)
            if self._error is not None:
                raise self._error
            raise StopIteration
        if hit:
            self.stats.hits += 1
            self._m_hits.inc()
        else:
            self.stats.misses += 1
            self._m_misses.inc()
        self.stats.consumed += 1
        self._m_depth.set(self._queue.qsize())
        return item

    def close(self, timeout: float | None = None) -> None:
        """Stop the producer and discard staged items (consumer gave up).

        Blocks until the producer thread exits (its current `next(source)`
        finishes; protocol termination envelopes bound that).  Callers that
        perform post-close rollback of staged work depend on the producer
        being genuinely stopped — pass a ``timeout`` only if a wedged
        producer is preferable to waiting, and check :meth:`producer_alive`
        afterwards.
        """
        self._stop.set()
        self._queue.close()  # wakes a producer blocked on a full queue NOW
        self._thread.join(timeout=timeout)
        self._finished = True

    @property
    def producer_alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self) -> "PrefetchIterator[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
