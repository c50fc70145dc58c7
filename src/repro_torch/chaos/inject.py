"""Fault injectors: the bridge from a :class:`ChaosPlan` to the runtime hooks.

Each injector targets one of the seams the runtime exposes on purpose:

  * :class:`CollectiveInjector` — the ``injector`` hook of
    :class:`repro_torch.core.comm.ResilientCollective` (queried per
    (round, attempt, rank, tag); faults are *simulated* against the
    deadline, so chaos runs spend no wall clock on the faults themselves);
  * :func:`poison_samples` — the module hook of
    :func:`repro_torch.data.pipeline.set_pipeline_fault_hook` (a poison sample's
    corruption manifests only when the online pipeline realizes it);
  * :func:`make_worker_killer` — the ``fault_hook`` of
    :class:`repro_torch.stream.workers.WorkerPool` (SIGKILL at a planned
    submission ordinal);
  * :func:`truncate_file` — torn-write simulation for checkpoint artifacts.

Every injection increments the ``odb_fault_injected_total`` counter family
(labelled by kind), so a chaos run's telemetry states exactly what was done
to it alongside what it recovered from (DESIGN.md §13).
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import signal

from repro_torch import obs
from repro_torch.chaos.plan import ChaosPlan, unit_hash
from repro_torch.data.pipeline import (
    RawRecord,
    SampleCorruptionError,
    set_pipeline_fault_hook,
)


def _count(kind: str) -> None:
    obs.counter(
        "odb_fault_injected_total",
        help="faults injected by the chaos harness",
        kind=kind,
    ).inc()


class CollectiveInjector:
    """Plan-driven ``on_gather`` hook for :class:`ResilientCollective`.

    ``kind`` selects the failure shape:

      * ``"gather_delay"`` — with probability ``rate`` per (round, rank), the
        delivery takes up to ``max_delay_s`` (a fault iff that exceeds the
        wrapper's deadline).  Transient: the fault fires on attempt 0 only,
        so one retry always recovers it.
      * ``"gather_drop"`` — the payload is lost on *every* attempt (hard
        fault: the retry budget exhausts and the gather raises
        ``RankTimeoutError``).  Sites come from the plan with probability
        ``rate`` per (round, rank), or — with ``at_round`` set — exactly one
        plan-chosen rank at that round (the deterministic mid-epoch outage
        the abort/resume scenario needs).
      * ``"slow_rank"`` — rank ``slow_rank`` always delivers late by
        ``max_delay_s`` (meant to sit *below* the deadline: a persistent
        straggler that must not trigger the fault machinery at all).

    Only primary-tag gathers are faulted; the optional secondary gather of a
    round shares the wrapper's round ordinal and faulting both would
    double-count sites against the plan's per-round rate.
    """

    def __init__(
        self,
        plan: ChaosPlan,
        *,
        kind: str,
        rate: float = 0.0,
        max_delay_s: float = 0.0,
        slow_rank: int = 0,
        at_round: int | None = None,
    ) -> None:
        if kind not in ("gather_delay", "gather_drop", "slow_rank"):
            raise ValueError(f"unknown collective fault kind {kind!r}")
        self.plan = plan
        self.kind = kind
        self.rate = rate
        self.max_delay_s = max_delay_s
        self.slow_rank = slow_rank
        self.at_round = at_round
        self.injected = 0

    def on_gather(
        self, round_index: int, attempt: int, rank: int, tag: str
    ) -> str | float | None:
        if tag != "primary":
            return None
        if self.kind == "slow_rank":
            if rank != self.slow_rank:
                return None
            self.injected += 1
            _count(self.kind)
            return self.max_delay_s
        if self.kind == "gather_delay":
            if attempt > 0:  # transient: clean delivery on retry
                return None
            delay = self.plan.delay(
                round_index, rank, rate=self.rate, max_delay_s=self.max_delay_s
            )
            if delay is None:
                return None
            self.injected += 1
            _count(self.kind)
            return delay
        # gather_drop: persists across attempts (hard fault)
        if self.at_round is not None:
            victim = int(
                unit_hash("drop-rank", self.plan.seed) * self.plan.world_size
            )
            if round_index != self.at_round or rank != victim:
                return None
        elif not self.plan.drop(round_index, rank, rate=self.rate):
            return None
        self.injected += 1
        _count(self.kind)
        return "drop"


@contextlib.contextmanager
def poison_samples(identities):
    """Install a pipeline fault hook failing realization for ``identities``.

    Restores the previous hook on exit, so harness scenarios can nest inside
    instrumented runs without leaking global state into later tests.
    """
    poison = frozenset(identities)

    def hook(record: RawRecord, policy, epoch) -> None:
        if record.identity in poison:
            _count("poison_sample")
            raise SampleCorruptionError(
                f"pipeline failed for identity {record.identity} (injected)"
            )

    previous = set_pipeline_fault_hook(hook)
    try:
        yield poison
    finally:
        set_pipeline_fault_hook(previous)


def make_worker_killer(kill_seq: int):
    """``WorkerPool`` fault hook: SIGKILL *every* live worker at submission
    ``kill_seq`` (once) — the DESIGN.md §14 hard-failure drill.  The pool's
    liveness audit must then re-execute all claimed tasks and degrade to
    in-process execution without dropping or reordering steps.

    All workers die together deliberately: a lone SIGKILL can land while the
    victim holds the task queue's reader lock, wedging the *surviving*
    workers on a lock nobody will release — a failure mode of the injection
    mechanism, not of the pool (the pool's stall escalation still terminates,
    just at stall_timeout per step).  Total loss is the deterministic drill.
    """
    state = {"killed": False}

    def hook(pool, seq: int) -> None:
        if state["killed"] or seq != kill_seq:
            return
        state["killed"] = True
        victims = [p for p in pool._procs if p.is_alive()]
        for proc in victims:
            _count("worker_kill")
            os.kill(proc.pid, signal.SIGKILL)
        for proc in victims:
            proc.join(timeout=10)

    return hook


def truncate_file(path: str | os.PathLike, fraction: float) -> int:
    """Tear a file to its first ``fraction`` of bytes (torn-write simulation).

    Returns the new size.  ``fraction`` is clamped to [0, 1); a checkpoint
    torn this way must be detected and skipped by restore, never half-read.
    """
    p = pathlib.Path(path)
    data = p.read_bytes()
    keep = int(len(data) * min(max(fraction, 0.0), 0.999))
    _count("ckpt_truncate")
    p.write_bytes(data[:keep])
    return keep
