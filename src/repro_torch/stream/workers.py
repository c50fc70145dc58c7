"""Multi-process prefetch workers: GIL-free window realization with
shared-memory staging (DESIGN.md §14).

The in-process prefetcher (stream/prefetch.py) overlaps data-side work with
the train step, but the heavy per-step work — layout planning,
first-fit packing, token synthesis, bucket padding — shares the GIL with the
DGAP protocol rounds, so the ``pf·nw`` overlap envelope is cooperative, not
parallel.  This module makes it real: a pool of ``nw`` **spawn**-based worker
processes pulls per-step realization tasks over a task queue and returns the
completed step arrays through preallocated ``multiprocessing.shared_memory``
ring slots.

Protocol (one message kind per line, all via the two mp queues):

    parent -> worker:   ("task", seq, index, slot, step_codec)   | None (stop)
    worker -> parent:   ("claim", wid, seq)
                        ("done",  wid, seq, header, inline|None)
                        ("error", wid, seq, traceback_text)
                        ("obs",   wid, timestamp, registry_state)

Ordering: tasks are sequence-numbered at submission; results may return out
of order (workers race), so the parent holds completed results in a reorder
buffer and releases them strictly by ``seq``.  Delivery order is therefore
identical to the in-process path — which is what keeps Theorem-1 identity
coverage, checkpoint/resume bit-exactness and rank-aligned SPMD shapes
worker-count-agnostic.

Shared-memory ring: ``slots`` fixed-size slots in one segment.  A slot is
acquired at submission (no free slot = natural backpressure: at most
``slots`` steps are ever in flight), written by exactly one worker, read
zero-copy by the consumer (numpy views straight over the slot buffer), and
recycled only when the consumer releases the delivered step — so a view is
never invalidated while the step is still being trained on.  A step too
large for a slot degrades to an inline (pickled-through-the-queue) result and
``odb_worker_shm_overflows_total`` counts it; nothing is ever dropped.

Failure semantics: a dead worker (OOM-killed, segfaulted) is detected by
liveness polling whenever results stall; its claimed-but-unfinished tasks are
re-executed in-process with a warning and ``odb_worker_failures_total``
ticks once per lost worker.  Unclaimed tasks stay on the queue for surviving
workers; when no workers survive, the pool drains its own queue and runs
degraded (every remaining task in-process) — never a hang, never a dropped
sample.

Observability: each worker runs its own (fresh, spawn-isolated) default
registry; its layout counters (``odb_layout_*``) accumulate worker-side and
are shipped to the parent every :data:`OBS_SYNC_EVERY` tasks and at exit,
where :class:`repro_torch.obs.CrossProcessAggregator` merges them (counters sum by
delta, gauges last-write-by-timestamp) into the parent registry — one
``metrics.json`` reports the whole process tree.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import queue as queue_mod
import time
import traceback
import warnings
from typing import Callable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.grouping import Group, Sample
from repro_torch.core.layout import BatchLayout, DeviceBatch

__all__ = [
    "DEFAULT_SLOT_BYTES",
    "OBS_SYNC_EVERY",
    "WorkerPool",
    "WorkerPoolStats",
    "WorkerResult",
]

#: Default per-slot byte budget.  Sized for the shipped shape cells (a 4-rank
#: packed 16k-token step is ~4 MiB); steps that exceed it fall back to inline
#: delivery rather than failing.
DEFAULT_SLOT_BYTES = 8 << 20

#: Ship the worker-side registry state to the parent every N completed tasks
#: (and always at clean exit).
OBS_SYNC_EVERY = 16

_ALIGN = 8

# (field, dtype, per-row?) layout of one DeviceBatch inside a slot.
_FIELDS = (
    ("tokens", np.int32),
    ("positions", np.int32),
    ("segments", np.int32),
    ("loss_mask", np.float32),
    ("lengths", np.int32),
)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


# -----------------------------------------------------------------------------
# Step codec (queue-side): samples flatten to (view_id, identity, length)
# triples, IDLE/None to None — mirrors stream/state.py but avoids importing
# the protocol layer into the worker interpreter.
# -----------------------------------------------------------------------------


def _encode_step(step: Sequence[Group | None]) -> list:
    return [
        None
        if g is None
        else [(s.view_id, s.identity, s.length) for s in g.samples]
        for g in step
    ]


def _decode_step(data: list) -> list[Group | None]:
    return [
        None
        if g is None
        else Group(
            samples=tuple(
                Sample(view_id=v, identity=i, length=l) for v, i, l in g
            )
        )
        for g in data
    ]


# -----------------------------------------------------------------------------
# Slot serialization: header = per-rank shapes/offsets, payload = raw arrays.
# -----------------------------------------------------------------------------


def _slot_plan(batches: Sequence[DeviceBatch]) -> tuple[list[dict], int]:
    """Per-batch field offsets within a slot, plus the total byte need."""
    cursor = 0
    headers = []
    for b in batches:
        rows, t = b.tokens.shape
        offsets = {}
        for field, dtype in _FIELDS:
            arr = getattr(b, field)
            offsets[field] = cursor
            cursor = _aligned(cursor + arr.nbytes)
        headers.append(
            {
                "shape": (int(rows), int(t)),
                "offsets": offsets,
                "real_samples": b.real_samples,
                "real_tokens": b.real_tokens,
            }
        )
    return headers, cursor


def _write_slot(buf: memoryview, base: int, batches: Sequence[DeviceBatch],
                headers: list[dict]) -> None:
    for b, h in zip(batches, headers):
        for field, dtype in _FIELDS:
            arr = np.ascontiguousarray(getattr(b, field))
            off = base + h["offsets"][field]
            buf[off : off + arr.nbytes] = arr.tobytes()


def _read_slot(buf: memoryview, base: int, headers: list[dict]) -> list[DeviceBatch]:
    """Zero-copy: numpy views straight over the shared-memory slot."""
    out = []
    for h in headers:
        rows, t = h["shape"]
        arrays = {}
        for field, dtype in _FIELDS:
            count = rows if field == "lengths" else rows * t
            view = np.frombuffer(
                buf, dtype=dtype, count=count, offset=base + h["offsets"][field]
            )
            arrays[field] = view if field == "lengths" else view.reshape(rows, t)
        out.append(
            DeviceBatch(
                **arrays,
                real_samples=h["real_samples"],
                real_tokens=h["real_tokens"],
            )
        )
    return out


# -----------------------------------------------------------------------------
# Worker process
# -----------------------------------------------------------------------------


def _attach_shm(name: str):
    """Attach without resource_tracker ownership (the parent owns the ring;
    a child tracker 'cleaning up' the segment would unlink it under the
    parent's feet)."""
    from multiprocessing import shared_memory

    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:  # < 3.13: no track kwarg; suppress registration.
        # (unregister-after-attach is wrong here: spawn children share the
        # parent's tracker process, so the extra unregister would race the
        # parent's own unlink-time unregister of the same name.)
        from multiprocessing import resource_tracker

        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **kw: None
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig


def _worker_main(
    worker_id: int,
    task_q,
    result_q,
    shm_name: str,
    slot_bytes: int,
    layout_blob: bytes,
) -> None:
    """Worker loop: decode task -> layout.build_step -> stage into the slot.

    Runs in a fresh spawned interpreter: no torch, no CUDA context, no inherited locks, its own
    default registry (merged back via "obs" messages).
    """
    layout: BatchLayout = pickle.loads(layout_blob)
    shm = _attach_shm(shm_name)
    tasks_done = 0

    def ship_obs() -> None:
        state = obs.default_registry().state()
        if state:
            result_q.put(("obs", worker_id, time.time(), state))

    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            _, seq, index, slot, step_codec = task
            result_q.put(("claim", worker_id, seq))
            try:
                step = _decode_step(step_codec)
                batches = layout.build_step(step)
                headers, need = _slot_plan(batches)
                if slot is not None and need <= slot_bytes:
                    _write_slot(shm.buf, slot * slot_bytes, batches, headers)
                    result_q.put(("done", worker_id, seq, headers, None))
                else:
                    # Step too large for the ring slot: inline fallback.
                    result_q.put(("done", worker_id, seq, None, batches))
                tasks_done += 1
                if tasks_done % OBS_SYNC_EVERY == 0:
                    ship_obs()
            except BaseException:
                result_q.put(("error", worker_id, seq, traceback.format_exc()))
    finally:
        try:
            ship_obs()
        except Exception:
            pass
        shm.close()


# -----------------------------------------------------------------------------
# Parent-side pool
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerPoolStats:
    submitted: int = 0  # tasks handed to the pool
    completed: int = 0  # results delivered in order
    shm_results: int = 0  # staged through the shared-memory ring
    inline_results: int = 0  # slot overflow -> pickled through the queue
    reexecuted: int = 0  # run in-process after a worker loss / degradation
    worker_failures: int = 0  # workers that died with tasks outstanding
    wait_s: float = 0.0  # parent time blocked on worker results

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class WorkerResult:
    """One in-order completed step: arrays + the slot-release handle."""

    index: int
    step: list[Group | None]
    batches: list[DeviceBatch]
    release: Callable[[], None]  # idempotent; recycles the shm slot (if any)


@dataclasses.dataclass
class _Pending:
    index: int
    step: list[Group | None]
    slot: int | None
    claimed_by: int | None = None


class WorkerPool:
    """``nw`` spawned layout workers around a shared-memory slot ring.

    Mechanism only: :meth:`submit` enqueues one aligned step (non-blocking;
    callers gate on :meth:`can_submit`, which is exactly the free-slot
    backpressure), :meth:`take` blocks for the *next in-order* result, and
    :meth:`close` tears everything down.  Pump/ordering policy lives in
    ``OnlineDynamicLoader.streaming_epoch``.
    """

    def __init__(
        self,
        layout: BatchLayout,
        num_workers: int,
        *,
        slots: int | None = None,
        slot_bytes: int = DEFAULT_SLOT_BYTES,
        poll_interval: float = 0.2,
        stall_timeout: float = 30.0,
        fault_hook=None,
    ) -> None:
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        import multiprocessing as mp
        from multiprocessing import shared_memory

        self.layout = layout
        self.num_workers = num_workers
        self.slots = slots if slots is not None else max(2 * num_workers, 4)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        self.slot_bytes = slot_bytes
        self.stats = WorkerPoolStats()
        self._poll_interval = poll_interval
        self._stall_timeout = stall_timeout
        # Chaos injection (repro_torch.chaos): called as fault_hook(pool, seq) right
        # after each task is enqueued, so a harness can kill a worker process
        # at a deterministic submission index and exercise the reclaim path.
        self._fault_hook = fault_hook
        self._activity = 0  # bumps on every worker message; take()'s stall clock
        self._ctx = mp.get_context("spawn")
        self._shm = shared_memory.SharedMemory(
            create=True, size=self.slots * slot_bytes
        )
        self._free_slots: collections.deque[int] = collections.deque(
            range(self.slots)
        )
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        self._agg = obs.CrossProcessAggregator()
        self._pending: dict[int, _Pending] = {}
        self._completed: dict[int, tuple[list[DeviceBatch], int | None]] = {}
        self._next_seq = 0
        self._next_out = 0
        self._closed = False
        self._degraded = False  # all workers lost -> in-process execution
        self._dead_handled: set[int] = set()
        layout_blob = pickle.dumps(layout)
        self._procs = [
            self._ctx.Process(
                target=_worker_main,
                args=(
                    wid, self._task_q, self._result_q,
                    self._shm.name, slot_bytes, layout_blob,
                ),
                daemon=True,
                name=f"odb-worker-{wid}",
            )
            for wid in range(num_workers)
        ]
        for p in self._procs:
            p.start()

    # -- submission ------------------------------------------------------------
    @property
    def inflight(self) -> int:
        """Tasks submitted but not yet taken (pending + reordered)."""
        return len(self._pending) + len(self._completed)

    def can_submit(self) -> bool:
        return not self._closed and bool(self._free_slots)

    def submit(self, index: int, step: list[Group | None]) -> None:
        """Enqueue one aligned step.  Callers must gate on :meth:`can_submit`
        — a free ring slot per task is the backpressure invariant."""
        if self._closed:
            raise RuntimeError("worker pool is closed")
        if not self._free_slots:
            raise RuntimeError(
                "no free shared-memory slot; gate submissions on can_submit()"
            )
        seq = self._next_seq
        self._next_seq += 1
        self.stats.submitted += 1
        obs.counter(
            "odb_worker_tasks_total", help="steps submitted to the worker pool"
        ).inc()
        if self._degraded:
            # No workers left: execute at the submission point (still ordered).
            self._pending[seq] = _Pending(index, step, None)
            self._reexecute(seq)
            return
        slot = self._free_slots.popleft()
        self._pending[seq] = _Pending(index, step, slot)
        self._task_q.put(("task", seq, index, slot, _encode_step(step)))
        obs.gauge(
            "odb_worker_inflight", help="steps in flight in the worker pool"
        ).set(self.inflight)
        if self._fault_hook is not None:
            self._fault_hook(self, seq)

    # -- results ---------------------------------------------------------------
    def take(self) -> WorkerResult | None:
        """Block for the next *in-order* completed step; None when idle.

        Never hangs: whenever the result queue stalls past the poll interval,
        worker liveness is audited and lost workers' claimed tasks are
        re-executed in-process.
        """
        self._drain_results()  # absorb ready results + worker obs dumps
        if self._next_out not in self._pending:
            return None  # nothing submitted at this frontier
        t0 = time.perf_counter()
        last_activity = self._activity
        last_progress = t0
        while self._next_out not in self._completed:
            self._drain_results(timeout=self._poll_interval)
            if self._next_out in self._completed:
                break
            self._audit_liveness()
            now = time.perf_counter()
            if self._activity != last_activity:
                last_activity = self._activity
                last_progress = now
            elif now - last_progress > self._stall_timeout:
                # Total silence past the stall budget: the frontier task's
                # queue message is presumed lost (a worker can die between
                # reading a task and announcing its claim, taking the message
                # with it; a wedged worker looks the same).  Re-execute it
                # here — builds are deterministic, so a late duplicate from a
                # live worker is identical and gets dropped in _fulfill.
                warnings.warn(
                    f"odb step seq={self._next_out} stalled "
                    f">{self._stall_timeout:.1f}s in the worker pool; "
                    "re-executing in-process",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self._reexecute(self._next_out, free_slot=False)
        waited = time.perf_counter() - t0
        self.stats.wait_s += waited
        seq = self._next_out
        self._next_out += 1
        batches, slot = self._completed.pop(seq)
        pend = self._pending.pop(seq)
        self.stats.completed += 1
        release = self._make_release(slot)
        return WorkerResult(
            index=pend.index, step=pend.step, batches=batches, release=release
        )

    def _make_release(self, slot: int | None) -> Callable[[], None]:
        # One-shot across threads: the stage hook (producer side) and the
        # consumer loop may both call release(); list.pop() is atomic, so
        # exactly one caller recycles the slot.
        token = [] if slot is None else [slot]

        def release() -> None:
            try:
                s = token.pop()
            except IndexError:
                return
            if not self._closed:
                self._free_slots.append(s)

        return release

    # -- result-queue pump -----------------------------------------------------
    def _drain_results(self, timeout: float | None = None) -> None:
        block = timeout is not None
        while True:
            try:
                msg = self._result_q.get(block=block, timeout=timeout)
            except queue_mod.Empty:
                return
            block = False  # only the first get blocks; then drain
            self._activity += 1
            kind = msg[0]
            if kind == "claim":
                _, wid, seq = msg
                pend = self._pending.get(seq)
                if pend is not None:
                    pend.claimed_by = wid
            elif kind == "done":
                _, wid, seq, headers, inline = msg
                self._fulfill(seq, headers, inline)
            elif kind == "error":
                _, wid, seq, tb = msg
                # Deterministic task failure: re-execute in-process so the
                # real exception surfaces with a native traceback (and a
                # genuinely transient worker-side failure gets one retry).
                warnings.warn(
                    f"odb worker {wid} failed on step seq={seq}; "
                    f"re-executing in-process:\n{tb}",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self._reexecute(seq)
            elif kind == "obs":
                _, wid, ts, state = msg
                self._agg.merge(f"worker{wid}", state, ts)

    def _fulfill(self, seq: int, headers, inline) -> None:
        pend = self._pending.get(seq)
        if pend is None:
            return  # already taken (late duplicate); quarantined slot stays out
        if seq in self._completed:
            # A fallback re-execution beat this worker to it.  The worker is
            # done touching the slot now, so the quarantine can be lifted.
            if pend.slot is not None:
                self._free_slots.append(pend.slot)
                pend.slot = None
            return
        if inline is not None:
            # Overflow fallback: arrays came through the queue; the slot was
            # never written, recycle it immediately.
            self.stats.inline_results += 1
            obs.counter(
                "odb_worker_shm_overflows_total",
                help="steps too large for a shm slot (inline fallback)",
            ).inc()
            if pend.slot is not None:
                self._free_slots.append(pend.slot)
                pend.slot = None
            self._completed[seq] = (list(inline), None)
        else:
            self.stats.shm_results += 1
            batches = _read_slot(
                self._shm.buf, pend.slot * self.slot_bytes, headers
            )
            self._completed[seq] = (batches, pend.slot)

    def _reexecute(self, seq: int, free_slot: bool = True) -> None:
        """Run one submitted task in the parent process (fallback path).

        ``free_slot=False`` quarantines the task's shm slot instead of
        recycling it: used when a *live* worker might still hold the task
        (lost-message escalation) and could write the slot later — the slot
        is reclaimed if/when that duplicate ``done`` arrives (`_fulfill`).
        """
        pend = self._pending.get(seq)
        if pend is None or seq in self._completed:
            return
        batches = self.layout.build_step(pend.step)
        if free_slot and pend.slot is not None:
            self._free_slots.append(pend.slot)
            pend.slot = None
        self._completed[seq] = (batches, None)
        self.stats.reexecuted += 1
        obs.counter(
            "odb_worker_reexecuted_total",
            help="steps re-executed in-process after a worker failure",
        ).inc()

    # -- failure handling ------------------------------------------------------
    def _audit_liveness(self) -> None:
        dead = [
            p for p in self._procs
            if not p.is_alive() and p.pid not in self._dead_handled
        ]
        if not dead:
            return
        # A final drain first: a worker may have finished results (or shipped
        # obs state) between its last task and its death.
        self._drain_results(timeout=None)
        for p in dead:
            self._dead_handled.add(p.pid)
            wid = int(p.name.rsplit("-", 1)[-1])
            self.stats.worker_failures += 1
            obs.counter(
                "odb_worker_failures_total",
                help="worker processes lost mid-epoch",
            ).inc()
            claimed = [
                seq for seq, pend in sorted(self._pending.items())
                if pend.claimed_by == wid and seq not in self._completed
            ]
            if claimed:
                warnings.warn(
                    f"odb worker {wid} (pid {p.pid}, exitcode {p.exitcode}) "
                    f"died with {len(claimed)} in-flight step(s); "
                    "re-executing in-process",
                    RuntimeWarning,
                    stacklevel=3,
                )
            for seq in claimed:
                self._reexecute(seq)
        if any(p.is_alive() for p in self._procs):
            # A worker can die *between* reading a task message and sending
            # its claim — the message is gone and nobody owns the task.  At
            # most one task per death can be orphaned that way (the oldest
            # unclaimed one, since the queue is FIFO); re-execute one suspect
            # per dead worker, slot quarantined in case a live worker does
            # still deliver it (duplicates are dropped in _fulfill).
            for _ in dead:
                orphan = next(
                    (
                        seq for seq in sorted(self._pending)
                        if self._pending[seq].claimed_by is None
                        and seq not in self._completed
                    ),
                    None,
                )
                if orphan is None:
                    break
                self._reexecute(orphan, free_slot=False)
        if not any(p.is_alive() for p in self._procs):
            # No workers left: reclaim every queued-but-unclaimed task and run
            # the rest of the epoch degraded (in-process, still in order).
            if not self._degraded:
                warnings.warn(
                    "all odb workers lost; continuing in-process (degraded)",
                    RuntimeWarning,
                    stacklevel=3,
                )
            self._degraded = True
            while True:
                try:
                    self._task_q.get_nowait()
                except queue_mod.Empty:
                    break
            for seq in sorted(self._pending):
                self._reexecute(seq)

    @property
    def alive_workers(self) -> int:
        return sum(1 for p in self._procs if p.is_alive())

    # -- teardown --------------------------------------------------------------
    def close(self) -> None:
        """Stop workers, drop undelivered results, unlink the shm ring.

        Submitted-but-undelivered steps are simply discarded here — the
        loader re-queues their protocol-side ``step`` objects into the
        executor (`requeue`), so worker state never needs to survive into a
        checkpoint: resume is worker-count-agnostic by construction.
        """
        if self._closed:
            return
        self._closed = True
        for p in self._procs:
            if p.is_alive():
                try:
                    self._task_q.put_nowait(None)
                except Exception:
                    break
        # Absorb any final obs dumps workers flush on their way out.
        deadline = time.perf_counter() + 2.0
        while (
            any(p.is_alive() for p in self._procs)
            and time.perf_counter() < deadline
        ):
            try:
                self._drain_results(timeout=0.05)
            except Exception:
                break
        try:
            self._drain_results(timeout=None)
        except Exception:
            pass
        for p in self._procs:
            p.join(timeout=1.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for q in (self._task_q, self._result_q):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass
        self._pending.clear()
        self._completed.clear()
        try:
            self._shm.close()
        except BufferError:
            # Delivered zero-copy views still reference the mapping: drop our
            # handles so the mapping dies with the last view instead of a
            # second (unraisable) close attempt from SharedMemory.__del__.
            # The segment is unlinked below, so nothing outlives the process.
            self._shm._mmap = None
            fd = getattr(self._shm, "_fd", -1)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                self._shm._fd = -1
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # belt-and-braces; close() is the real path
        try:
            self.close()
        except Exception:
            pass
