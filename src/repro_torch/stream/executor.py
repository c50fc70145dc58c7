"""Streaming DGAP executor (DESIGN.md §9.2).

``StreamExecutor`` makes ODB genuinely online: the incremental
:class:`repro_torch.core.protocol.EpochRunner` drives protocol rounds one at a
time, pulling sampler views through the bounded-lookahead
:class:`AdmissionWindow` — realized lengths enter existence only as the
window admits them, and aligned steps leave the executor as soon as a round
produces them.  The full per-epoch length list is never materialized.

Equivalence guarantee (tests/test_stream.py, and tests/test_torch_stream.py
against the JAX package): with ``lookahead >= M`` the
window never throttles a fetch, every protocol round sees exactly the state
the offline engine would, and the delivered step sequence is bit-for-bit the
``odb_schedule`` sequence for the same (seed, epoch, config).  With a tighter
lookahead the schedule legitimately differs — grouping sees a narrower
window — but Theorem 1 coverage is unchanged: every view is still admitted,
fetched, grouped and emitted exactly once.

Checkpoint/resume: ``checkpoint()`` between any two ``step()`` calls
serializes window cursor, residual pools and emit accounting
(stream/state.py); ``StreamExecutor.resume`` reconstructs an executor that
continues the identical step sequence, so mid-epoch preemption preserves
exact-identity coverage.

Fault tolerance (DESIGN.md §15): with ``config.round_deadline_s`` set (or a
chaos injector installed) the engine's collective is wrapped in
:class:`repro_torch.core.comm.ResilientCollective`.  A transient gather fault is
retried transparently; an unrecoverable one surfaces as
:class:`EpochAborted`, which carries a *valid* resumable checkpoint — the
failed gather left no observable protocol change (payloads are memoized in
the wrapper and the round index never advanced), so resuming replays the
identical round and the combined pre-abort + post-resume step stream is the
uninterrupted one.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Iterator

from repro_torch import obs
from repro_torch.core.comm import RankTimeoutError, ResilientCollective
from repro_torch.core.grouping import Group
from repro_torch.core.protocol import (
    EpochAudit,
    EpochRunner,
    OdbConfig,
    OdbProtocolEngine,
)
from repro_torch.data.pipeline import PipelinePolicy, RawRecord
from repro_torch.data.sampler import (
    ITERATION_VIEW_ID_STRIDE,
    SamplerSpec,
    iteration_shuffle_epoch,
)
from repro_torch.stream.state import (
    STATE_VERSION,
    StreamCheckpoint,
    bitmap_to_identities,
    identities_to_bitmap,
    load_rank_state,
    rank_state_dict,
    step_from_json,
    step_to_json,
)
from repro_torch.stream.window import (
    AdmissionWindow,
    QuarantineLedger,
    ShardedWindow,
    WindowRouter,
    WindowStats,
)


class EpochAborted(RuntimeError):
    """Degraded-mode epoch closure (DESIGN.md §15.4).

    Raised by :meth:`StreamExecutor.step` when a round's collective exhausts
    its retry budget (:class:`repro_torch.core.comm.RankTimeoutError`).  The epoch
    is *not* lost: the failed gather left no observable protocol change, so
    :meth:`checkpoint` (lazy — taken on first call, under the executor lock)
    yields a valid stream checkpoint from which ``StreamExecutor.resume``
    replays the aborted round and continues the identical step sequence.

    ``failed_ranks`` forwards the cause's full casualty list (every rank
    that failed the final delivery attempt, not just the first), so abort
    handling — operator logs, ``stream_abort.json`` — keeps the whole
    straggler census.
    """

    def __init__(self, cause: BaseException, executor: "StreamExecutor") -> None:
        super().__init__(f"epoch aborted: {cause}")
        self.cause = cause
        self._executor = executor
        self._checkpoint: StreamCheckpoint | None = None

    @property
    def failed_ranks(self) -> list[int]:
        return list(getattr(self.cause, "failed_ranks", []) or [])

    def checkpoint(self) -> StreamCheckpoint:
        if self._checkpoint is None:
            self._checkpoint = self._executor.checkpoint()
        return self._checkpoint


class StreamExecutor:
    """Step-at-a-time ODB epoch over a bounded admission window."""

    def __init__(
        self,
        records: list[RawRecord],
        policy: PipelinePolicy,
        world_size: int,
        config: OdbConfig,
        *,
        seed: int = 0,
        epoch: int = 0,
        lookahead: int | None = None,
        max_logical_iterations: int = 64,
        dataset_identities: int | None = None,
        fault_injector=None,
        num_hosts: int = 1,
    ) -> None:
        n = len(records) if dataset_identities is None else dataset_identities
        self.records = records
        self.policy = policy
        self.config = config
        self.seed = seed
        self.epoch = epoch
        self.max_logical_iterations = max_logical_iterations
        self.spec = SamplerSpec(dataset_size=n, world_size=world_size, seed=seed)
        if num_hosts < 1 or num_hosts > world_size:
            raise ValueError(
                f"num_hosts {num_hosts} must be in [1, world_size "
                f"{world_size}] (each host owns a contiguous, possibly "
                "uneven rank block)"
            )
        # P > 1 runs one ShardedWindow per host behind a WindowRouter — the
        # in-process simulation of a multi-host deployment (DESIGN.md §16).
        # The delivered step stream is bit-identical for every host count:
        # window state is per-rank decomposed, so partitioning ranks over
        # hosts changes nothing the protocol can observe.
        self.num_hosts = num_hosts
        self.lookahead = (
            self.spec.total_views if lookahead is None else lookahead
        )
        if self.lookahead < world_size:
            # Fail at construction, not at the first window build: a full
            # lookahead budget could otherwise hold no view for the
            # requesting rank (see AdmissionWindow).
            raise ValueError(
                f"lookahead {self.lookahead} < world_size {world_size}"
            )
        if config.output_capacity is not None:
            # Incremental delivery drains out_queue after every round, so the
            # C_r envelope would never bind and the schedule would silently
            # diverge from the eager path's.  Streaming backpressure comes
            # from the admission window + the bounded prefetch queue instead.
            raise ValueError(
                "output_capacity is an eager-path knob; the streaming "
                "executor's backpressure is lookahead + prefetch depth"
            )
        # Chaos injection (repro_torch.chaos): queried per (round, attempt, rank)
        # by the ResilientCollective wrapper.  None in production unless a
        # harness installs one; installing one also turns the wrapper on.
        self.fault_injector = fault_injector
        # Degraded-mode latch: once a round aborts, subsequent step() calls
        # re-raise instead of re-driving rounds into the same dead transport —
        # recovery is checkpoint + resume, not silent retry-forever.
        self.aborted = False
        self._abort_cause: BaseException | None = None
        self.window: AdmissionWindow | WindowRouter | None = None
        self._closed_window_stats: list[WindowStats] = []
        # step()/checkpoint()/audit() are serialized so a checkpoint taken
        # from the trainer thread while a prefetch producer thread is inside
        # a protocol round snapshots a step boundary, never a torn mid-round
        # state (the resume guarantee depends on this).
        self._lock = threading.RLock()
        # Per-epoch DGAP round audit (DESIGN.md §13.3): every protocol round
        # and every iteration closure lands here via the engine/runner hooks;
        # checkpoint() serializes it so a resumed run's audit is continuous.
        self.telemetry = obs.RoundTimeline(world_size)
        self._m_steps = obs.counter(
            "odb_stream_steps_total", help="aligned steps delivered by the executor"
        )
        self.runner = EpochRunner(
            self._make_engine,
            n,
            config,
            world_size=world_size,
            max_logical_iterations=max_logical_iterations,
            incremental=True,
        )
        self.runner.on_closure = self._on_closure

    # -- telemetry hooks -------------------------------------------------------
    def _on_round(self, record) -> None:
        self.telemetry.record_round(
            record, record.duration_s, self.runner.iteration
        )

    def _on_closure(self, event: str, iteration: int, rounds: int) -> None:
        self.telemetry.record_closure(event, iteration, rounds)

    # -- fault hooks -------------------------------------------------------------
    def _on_quarantine(self, position: int, identity: int, exc: BaseException) -> None:
        # Fold a window-level quarantine into the epoch-level Lemma-1
        # accounting: the identity joins component X, which shrinks the
        # effective quota so non-join termination cannot chase a poison
        # identity across logical iterations forever (Theorem 2 caveat, §15).
        self.runner.note_quarantine(identity)

    def _on_remote_quarantine(self, identity: int) -> None:
        # §16 merge path: an identity another host's window quarantined
        # arrives through the gather payload.  Folding it into the runner
        # keeps non-join closure on the MERGED |X| even when host ledgers
        # are not shared (a real deployment); in the in-process lane the
        # shared ledger makes this a no-op by idempotence.
        self.runner.note_quarantine(identity)

    # -- iteration factory -----------------------------------------------------
    def _make_window(self, iteration: int) -> AdmissionWindow | WindowRouter:
        # The quarantine budget is per *epoch* and charges each distinct
        # sample once: a new window gets whatever headroom earlier iterations
        # left unspent, and identities already in X are exempt — a non-join
        # catch-up iteration (or a resumed run) re-walks the order and meets
        # the same deterministically-failing sample again, which must not
        # re-spend the budget.
        budget = max(
            0, self.config.max_quarantine - len(self.runner.quarantined_ids)
        )
        exempt = frozenset(self.runner.quarantined_ids)
        kwargs = dict(
            shuffle_epoch=iteration_shuffle_epoch(self.epoch, iteration),
            pipeline_epoch=self.epoch,
            lookahead=self.lookahead,
            view_id_base=iteration * ITERATION_VIEW_ID_STRIDE,
        )
        window: AdmissionWindow | WindowRouter
        if self.num_hosts == 1:
            window = AdmissionWindow(
                self.records,
                self.policy,
                self.spec,
                max_quarantine=budget,
                quarantine_exempt=exempt,
                **kwargs,
            )
        else:
            # One window per simulated host, all over the same deterministic
            # order, each serving only its rank block.  The ledger is shared
            # so the per-epoch quarantine budget charges each distinct
            # sample once regardless of which host hits the failure first
            # (the padded order repeats identities across rank blocks).
            ledger = QuarantineLedger(budget, exempt)
            window = WindowRouter(
                [
                    ShardedWindow(
                        self.records,
                        self.policy,
                        self.spec,
                        host=host,
                        num_hosts=self.num_hosts,
                        ledger=ledger,
                        **kwargs,
                    )
                    for host in range(self.num_hosts)
                ]
            )
        window.on_quarantine = self._on_quarantine
        window.on_remote_quarantine = self._on_remote_quarantine
        return window

    def _make_engine(self, iteration: int) -> OdbProtocolEngine:
        if self.window is not None:
            self._closed_window_stats.append(self.window.stats)
        self.window = self._make_window(iteration)
        return self._build_engine(self.window)

    def _build_engine(
        self, window: AdmissionWindow | WindowRouter
    ) -> OdbProtocolEngine:
        # A lookahead tighter than the depth envelope throttles fetches to
        # O(lookahead/W) views per rank per round, so the Theorem-4 guard
        # widens from q + O(D) to q + O(D) + O(M) — still a hard finite
        # envelope, just sized for the throttled regime.
        engine = OdbProtocolEngine(
            [[] for _ in range(self.spec.world_size)],
            self.config,
            source=window,
            quota_hint=self.spec.per_rank_quota,
            round_margin=64 + self.spec.total_views,
        )
        engine.on_round = self._on_round
        if self.config.round_deadline_s is not None or self.fault_injector is not None:
            engine.collective = ResilientCollective(
                engine.collective,
                deadline_s=(
                    1.0
                    if self.config.round_deadline_s is None
                    else self.config.round_deadline_s
                ),
                max_retries=self.config.round_retries,
                backoff_base_s=self.config.retry_backoff_s,
                injector=self.fault_injector,
                seed=self.seed,
            )
        return engine

    # -- trainer-facing surface ------------------------------------------------
    def step(self) -> list[Group | None] | None:
        with self._lock:
            if self.aborted:
                raise EpochAborted(self._abort_cause, self)
            try:
                with obs.span("stream/step", cat="stream"):
                    out = self.runner.step()
            except RankTimeoutError as exc:
                # Degraded-mode closure (§15.4): latch, then surface the abort
                # carrying a lazy checkpoint.  We are between steps here (the
                # failed gather never mutated protocol state), so the
                # checkpoint is valid and resume replays the aborted round.
                self.aborted = True
                self._abort_cause = exc
                # Full casualty list into the round audit: the abort record
                # (and the checkpoint it rides in) names EVERY failed rank.
                self.telemetry.record_abort(
                    exc.failed_ranks,
                    round_index=exc.round_index,
                    attempts=exc.attempts,
                    reason=str(exc),
                )
                raise EpochAborted(exc, self) from exc
            if out is not None:
                self._m_steps.inc()
            return out

    def steps(self) -> Iterator[list[Group | None]]:
        while True:
            s = self.step()
            if s is None:
                return
            yield s

    def next_task(self) -> tuple[int, list[Group | None]] | None:
        """One ``(step_index, aligned_step)`` realization task, or None.

        The worker-pool pump (DESIGN.md §14) drives protocol rounds through
        this: task *emission* happens here, under the executor lock, while
        task *execution* (layout planning + padding + token synthesis) runs
        in worker processes — the protocol never waits on realization.  The
        pool itself holds no checkpointable state: tasks submitted but not
        consumed are rolled back via :meth:`requeue`, so a checkpoint is
        worker-count-agnostic and resume with any ``num_workers`` (including
        0) continues the identical step sequence.
        """
        with self._lock:
            step = self.step()
            if step is None:
                return None
            return self.runner.steps_delivered - 1, step

    @property
    def done(self) -> bool:
        return self.runner.done

    def requeue(self, steps) -> None:
        """Roll staged-but-unconsumed steps back (prefetch abandonment)."""
        with self._lock:
            self.runner.requeue(steps)

    def audit(self) -> EpochAudit:
        with self._lock:
            return self.runner.audit()

    def window_stats(self) -> WindowStats:
        """Aggregate admission stats across all iterations so far."""
        agg = WindowStats()
        windows = list(self._closed_window_stats)
        if self.window is not None:
            windows.append(self.window.stats)
        for st in windows:
            agg.realized += st.realized
            agg.delivered += st.delivered
            agg.refusals += st.refusals
            agg.quarantined += st.quarantined
            agg.peak_resident = max(agg.peak_resident, st.peak_resident)
        return agg

    # -- checkpoint / resume ---------------------------------------------------
    def checkpoint(self) -> StreamCheckpoint:
        """Snapshot the executor between two ``step()`` calls.

        Thread-safe: the snapshot is taken under the executor lock, so with a
        prefetch producer running it lands exactly on a step boundary (the
        producer-side frontier)."""
        with self._lock:
            return self._checkpoint_locked()

    def _checkpoint_locked(self) -> StreamCheckpoint:
        runner = self.runner
        engine = runner.engine
        payload = {
            "version": STATE_VERSION,
            "seed": self.seed,
            "epoch": self.epoch,
            # The host partition the checkpoint was TAKEN at — informational:
            # window state is per-rank (v4), so resume may regroup the ranks
            # onto any other divisor host count bit-exactly.
            "num_hosts": self.num_hosts,
            "world_size": self.spec.world_size,
            "dataset_identities": self.spec.dataset_size,
            "lookahead": self.lookahead,
            "max_logical_iterations": self.max_logical_iterations,
            "config": dataclasses.asdict(self.config),
            "policy_key": self.policy.cache_key("stream"),
            "num_records": len(self.records),
            "runner": {
                "iteration": runner.iteration,
                "emitted_total": runner.emitted_total,
                "emitted_bitmap": identities_to_bitmap(runner.emitted_ids),
                "rounds": runner.rounds,
                "rounds_offline_extra": runner.rounds_offline_extra,
                "abandoned": list(runner.abandoned),
                "steps_delivered": runner.steps_delivered,
                "terminated_by": runner.terminated_by,
                "done": runner.done,
                "iteration_open": runner._iteration_open,
                "iter_rounds": runner._iter_rounds,
                "ready": [step_to_json(s) for s in runner._ready],
                # Component X (v3): a small sorted list, not a bitmap — it is
                # bounded by max_quarantine, and the base-window sentinel
                # identity -1 would not fit a dense bitmap anyway.
                "quarantined_ids": sorted(runner.quarantined_ids),
                "quarantined_views": runner.quarantined_views,
            },
            "engine": None
            if engine is None
            else {
                "round_index": engine._round_index,
                "ranks": [rank_state_dict(r) for r in engine.ranks],
            },
            "window": None
            if engine is None or self.window is None
            else self.window.state_dict(),
            # A window whose iteration just finished (engine dropped) isn't
            # serialized above; fold its stats in so resumed-run metrics
            # still aggregate the whole epoch.
            "closed_window_stats": [
                st.as_dict() for st in self._closed_window_stats
            ]
            + (
                [self.window.stats.as_dict()]
                if engine is None and self.window is not None
                else []
            ),
            # Telemetry rides along (optional key, read back with .get() so
            # pre-telemetry checkpoints still resume): the round audit plus
            # the odb_* counter families, so a resumed run *continues* the
            # counters instead of restarting them at zero.
            "telemetry": {
                "rounds": self.telemetry.as_dict(),
                "counters": obs.default_registry().state(prefix="odb_"),
            },
        }
        return StreamCheckpoint(payload)

    @classmethod
    def resume(
        cls,
        checkpoint: StreamCheckpoint,
        records: list[RawRecord],
        policy: PipelinePolicy,
        *,
        fault_injector=None,
        num_hosts: int | None = None,
    ) -> "StreamExecutor":
        """Rebuild an executor that continues the checkpointed step sequence.

        ``records``/``policy`` are re-supplied by the caller (they are data,
        not state); the policy fingerprint is verified so a silently changed
        transform policy — which would drift realized lengths and break
        exact-identity coverage — fails loudly instead.

        ``num_hosts`` may differ from the checkpointing run's: v4 window
        state is per-rank, so an elastic restart regroups the rank states
        onto the new host partition and continues the identical step
        sequence (DESIGN.md §16).  ``None`` keeps the checkpointed count.
        """
        p = checkpoint.payload
        if policy.cache_key("stream") != p["policy_key"]:
            raise ValueError(
                "pipeline policy mismatch: checkpointed lengths were realized "
                "under a different transform policy"
            )
        if len(records) != p["num_records"]:
            raise ValueError(
                f"record count mismatch: {len(records)} != {p['num_records']}"
            )
        ex = cls(
            records,
            policy,
            p["world_size"],
            OdbConfig(**p["config"]),
            seed=p["seed"],
            epoch=p["epoch"],
            lookahead=p["lookahead"],
            max_logical_iterations=p["max_logical_iterations"],
            dataset_identities=p["dataset_identities"],
            fault_injector=fault_injector,
            num_hosts=p.get("num_hosts", 1) if num_hosts is None else num_hosts,
        )
        rs = p["runner"]
        runner = ex.runner
        runner.iteration = rs["iteration"]
        runner.quarantined_ids = set(rs.get("quarantined_ids", []))
        runner.quarantined_views = rs.get("quarantined_views", 0)
        runner.emitted_total = rs["emitted_total"]
        runner.emitted_ids = bitmap_to_identities(rs["emitted_bitmap"])
        runner.rounds = rs["rounds"]
        runner.rounds_offline_extra = rs.get("rounds_offline_extra", 0)
        runner.abandoned = list(rs["abandoned"])
        runner.steps_delivered = rs["steps_delivered"]
        runner.terminated_by = rs["terminated_by"]
        runner._done = rs["done"]
        runner._iteration_open = rs["iteration_open"]
        runner._iter_rounds = rs["iter_rounds"]
        runner._ready = collections.deque(
            step_from_json(s) for s in rs["ready"]
        )
        ex._closed_window_stats = [
            WindowStats(**st) for st in p.get("closed_window_stats", [])
        ]
        telemetry = p.get("telemetry")
        if telemetry is not None:
            ex.telemetry = obs.RoundTimeline.from_dict(telemetry["rounds"])
            obs.default_registry().load_state(telemetry["counters"])
        if p["engine"] is not None:
            window = ex._make_window(rs["iteration"])
            window.load_state_dict(p["window"])
            ex.window = window
            engine = ex._build_engine(window)
            for rank, st in zip(engine.ranks, p["engine"]["ranks"]):
                load_rank_state(rank, st)
            engine._round_index = p["engine"]["round_index"]
            runner._engine = engine
        return ex
