"""Unified loop protocol for the Distributed Group Alignment Problem (DGAP).

Implements the paper's §2.3 / App. A / App. C / App. E machinery:

  * per-rank state machine over the four disjoint components
    ``(R, Q, B, E)`` = (sampler-pending, worker queue, collate buffer,
    emitted) with the three transition primitives Fetch/Drain/Emit
    (App. C.1) — every transition moves sampler views between components,
    never creating or destroying them (Lemma 1, No-Leak);
  * one unconditional primary ``all_gather`` per outer round exchanging
    ``[idx_budget_r, n_groups_r, sizes_r (, tokens_r)]`` with
    ``n_groups_r ∈ {n>0, 0, -1}`` = produced / insufficient-data / finished;
  * Max-Based Bidirectional Group Alignment to the target ``T_grp`` (Eq. 3)
    with split / overflow-recirculate adjustment (Alg. 1);
  * **join mode** (default): ranks drain outstanding sampler views before
    advertising local finish; global completion only when *all* ranks
    advertise ``-1`` (Theorem 1 — strict identity coverage, η_logical = 0);
  * **non-join mode** (opt-in): the logical iteration ends when *any* rank
    advertises ``-1``; at most ``W·D`` fetched views are abandoned per
    logical iteration (Lemma 4) and the trainer chains logical iterations
    until the cumulative emit count reaches the quota
    ``N ≤ S_emit ≤ N + S_max`` (Theorem 2);
  * IDLE sentinels: a rank that emits fewer than ``T_grp`` real groups in a
    round pads its output queue with IDLE entries so per-step positions stay
    aligned across ranks.  In the JAX/SPMD adaptation an IDLE entry becomes a
    zero-token batch whose contribution is exactly annihilated by token-level
    loss scaling (Eq. 2 with ``t_r = 0``) — see DESIGN.md §2.

The engine simulates ``W`` ranks in-process, round-synchronously, through
``LoopbackCollective`` — the same per-rank methods can be driven by one
process per host over ``JaxProcessCollective`` on a real cluster.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Iterator, Sequence

from repro_torch import obs
from repro_torch.core.alignment import (
    AlignmentResult,
    RankAlignmentState,
    align_rank,
    alignment_target,
)
from repro_torch.core.comm import LoopbackCollective, ProtocolDesyncError
from repro_torch.core.grouping import Group, Sample, greedy_group

IDLE = None  # IDLE_DATA sentinel in the output queue


@dataclasses.dataclass(frozen=True)
class OdbConfig:
    """ODB knobs (paper §3.1 'Method-specific parameters')."""

    l_max: int  # per-step token budget L_max
    buffer_size: int = 1024  # grouping buffer (collate-side)
    prefetch_factor: int = 256  # pf
    num_workers: int = 4  # nw
    join_mode: bool = True  # default join (paper default; App. Q)
    output_capacity: int | None = None  # C_r envelope; None = unbounded
    exact_token_scaling: bool = True  # triggers the optional second gather
    # -- fault-tolerance knobs (DESIGN.md §15) ---------------------------------
    # Per-round collective delivery deadline; None disables the resilient
    # wrapper (no deadline, no retries — the pre-§15 behaviour).
    round_deadline_s: float | None = None
    round_retries: int = 2  # bounded retries before RankTimeoutError
    retry_backoff_s: float = 0.05  # backoff base (exponential, jittered)
    # Epoch budget of realization failures moved to quarantine component X;
    # 0 = strict (a poison sample raises, exactly the historical semantics).
    max_quarantine: int = 0

    @property
    def depth(self) -> int:
        """Outstanding-depth envelope ``D = max(pf*nw, buffer_size)`` (§2.3).

        When ``pf*nw < buffer_size`` the reset logic injects extra indices so
        the collate stage can assemble a full group — the clamp validated in
        App. P.
        """
        return max(self.prefetch_factor * self.num_workers, self.buffer_size)


@dataclasses.dataclass
class RankCounters:
    fetched: int = 0
    drained: int = 0
    emitted_views: int = 0
    emitted_groups: int = 0
    idle_slots: int = 0
    splits: int = 0
    overflow_groups: int = 0
    recirculated_views: int = 0


class ViewSource:
    """Lazy per-rank sampler-view source (streaming admission; DESIGN.md §9).

    The offline engine materializes the whole shard into ``R`` up front; a
    ``ViewSource`` instead hands views out incrementally so realized lengths
    stay bounded by the admission window.  The protocol only needs three
    observables per rank:

      * ``take(rank, k)``   — up to ``k`` more realized views (may under-fill
        when the admission window's lookahead budget is exhausted);
      * ``exhausted(rank)`` — no further views will ever arrive for ``rank``;
      * ``remaining(rank)`` — count of not-yet-delivered views (known exactly:
        the sampler's padded order has fixed size ``M = W·ceil(N/W)`` even
        though *lengths* are unknown until realization).
    """

    def take(self, rank: int, k: int) -> list[Sample]:  # pragma: no cover
        raise NotImplementedError

    def exhausted(self, rank: int) -> bool:  # pragma: no cover
        raise NotImplementedError

    def remaining(self, rank: int) -> int:  # pragma: no cover
        raise NotImplementedError

    # -- distributed-window fold (DESIGN.md §16; optional) ---------------------
    def shard_state(self, rank: int) -> dict | None:
        """Per-rank admission summary to fold into the round gather payload.

        ``None`` (the default) keeps the payload schema unchanged; a sharded
        window returns its host-local cursor/resident/quarantine summary so
        every host observes global admission state once per round.
        """
        return None

    def absorb_gathered(self, states: Sequence[dict | None]) -> None:
        """Merge the gathered per-rank window summaries (post-gather)."""


class RankRuntime:
    """Per-rank protocol state: the (R, Q, B, E) machine of App. C.1."""

    def __init__(
        self,
        rank: int,
        views: Sequence[Sample],
        config: OdbConfig,
        *,
        source: ViewSource | None = None,
    ):
        self.rank = rank
        self.config = config
        self.source = source  # lazy feeder of R (None = offline/materialized)
        self.pending: collections.deque[Sample] = collections.deque(views)  # R
        self.worker_queue: collections.deque[Sample] = collections.deque()  # Q
        self.buffer: list[Sample] = []  # B
        # E is conservation-counted, not stored: emitted views never re-enter
        # the machine, and identity coverage lives in EpochRunner.emitted_ids
        # — so the ledger (and its serialized form) is O(1), not O(quota).
        self.emitted_count: int = 0  # |E|
        self.out_queue: collections.deque[Group | None] = collections.deque()
        self.counters = RankCounters()
        self.local_finished = False
        self.admitted = len(self.pending)  # views ever entered into R
        # Straggler simulation: max views moved Q->B per round (None = all).
        self.drain_rate: int | None = None

    # -- invariants ----------------------------------------------------------
    def component_sizes(self) -> tuple[int, int, int, int]:
        return (
            len(self.pending),
            len(self.worker_queue),
            len(self.buffer),
            self.emitted_count,
        )

    @property
    def outstanding(self) -> int:
        """|U_r| = |Q_r ⊎ B_r| — fetched-but-not-emitted (Lemma 4)."""
        return len(self.worker_queue) + len(self.buffer)

    @property
    def total_views(self) -> int:
        return sum(self.component_sizes())

    @property
    def source_drained(self) -> bool:
        """True when no further views can ever enter ``R`` for this rank."""
        return self.source is None or self.source.exhausted(self.rank)

    @property
    def no_more_input(self) -> bool:
        """R and Q empty and the source (if any) can never refill them."""
        return not self.pending and not self.worker_queue and self.source_drained

    @property
    def idx_budget(self) -> int:
        """|R| plus the source's undelivered tail — equal to the offline
        engine's ``len(pending)`` for the same (seed, epoch, config)."""
        extra = 0 if self.source is None else self.source.remaining(self.rank)
        return len(self.pending) + extra

    # -- transition primitives (App. C.1) -------------------------------------
    def fetch_and_drain(self) -> None:
        """Fetch R->Q up to the depth envelope, then drain Q->B.

        The iterator schedules fetch/drain so the fetched-but-not-emitted set
        ``Q ⊎ B`` stays within ``D``; the collate buffer ``B`` itself is a
        bounded grouping window of at most ``buffer_size`` samples (paper
        §2.1: workers drain "into a configured grouping buffer") — larger
        buffers group over wider windows (Table 17's mechanism).
        """
        budget = self.config.depth - self.outstanding
        if self.source is not None and budget > len(self.pending):
            fresh = self.source.take(self.rank, budget - len(self.pending))
            self.pending.extend(fresh)
            self.admitted += len(fresh)
        while budget > 0 and self.pending:
            self.worker_queue.append(self.pending.popleft())
            self.counters.fetched += 1
            budget -= 1
        allowance = (
            len(self.worker_queue) if self.drain_rate is None else self.drain_rate
        )
        while (
            allowance > 0
            and self.worker_queue
            and len(self.buffer) < self.config.buffer_size
        ):
            self.buffer.append(self.worker_queue.popleft())
            self.counters.drained += 1
            allowance -= 1

    # -- round payload ---------------------------------------------------------
    def candidate_groups(self) -> list[Group]:
        """Form candidate groups when the buffer is ready (collate stage).

        Grouping triggers when the buffer has filled to ``buffer_size`` or the
        sampler + worker queue are exhausted (tail drain).  Otherwise the rank
        reports "insufficient data" (n_groups = 0) and the round only
        fetches/drains for it (skip behaviour, Lemma 2 case (b)).
        """
        ready = len(self.buffer) >= self.config.buffer_size or (
            self.no_more_input and self.buffer
        )
        if not ready:
            return []
        return greedy_group(self.buffer, self.config.l_max)

    def status_code(self, groups: Sequence[Group]) -> int:
        """n_groups ∈ {n>0, 0, -1}: produced / insufficient / finished."""
        if groups:
            return len(groups)
        if self.no_more_input and not self.buffer:
            return -1
        return 0

    @property
    def free_slots(self) -> int:
        if self.config.output_capacity is None:
            return 1 << 30  # effectively unbounded
        return max(self.config.output_capacity - len(self.out_queue), 0)

    # -- emission ----------------------------------------------------------------
    def emit_aligned(self, result: AlignmentResult, target: int) -> int:
        """Emit aligned groups, recirculate overflow, pad with IDLE to target."""
        emitted_now = 0
        emitted_view_ids = set()
        for group in result.groups:
            self.out_queue.append(group)
            self.emitted_count += group.size
            emitted_view_ids.update(s.view_id for s in group.samples)
            emitted_now += 1
            self.counters.emitted_groups += 1
            self.counters.emitted_views += group.size
        # Buffer keeps only recirculated + previously-unbuffered leftovers.
        recirc_ids = {s.view_id for s in result.recirculated}
        self.buffer = [
            s
            for s in self.buffer
            if s.view_id not in emitted_view_ids or s.view_id in recirc_ids
        ]
        self.counters.splits += result.splits
        self.counters.overflow_groups += result.overflowed_groups
        self.counters.recirculated_views += len(result.recirculated)
        while emitted_now < target:
            self.out_queue.append(IDLE)
            self.counters.idle_slots += 1
            emitted_now += 1
        return emitted_now


@dataclasses.dataclass
class RoundRecord:
    """Audit record of one outer protocol round (drives tests/benchmarks)."""

    round_index: int
    statuses: tuple[int, ...]
    idx_budgets: tuple[int, ...]
    target: int
    emitted_views: int
    skip_output: bool
    second_gather: bool
    potential: int  # Lyapunov Φ = Σ_r (|R|+|Q|+|B|)  (App. C.2)
    duration_s: float = 0.0  # wall time of the round (telemetry; DESIGN.md §13)


@dataclasses.dataclass
class IterationResult:
    """Outcome of one logical sampler iteration."""

    rounds: int
    emitted_views: int
    abandoned_views: int  # Σ|U_r| at a non-join stop (Lemma 4 envelope)
    records: list[RoundRecord]
    terminated_by: str  # "join_all_finished" | "nonjoin_any_finished"


class BoundedTerminationError(RuntimeError):
    """Round count exceeded the Theorem-4 envelope — a protocol bug."""


class OdbProtocolEngine:
    """Round-synchronous driver of the unified loop over W simulated ranks."""

    def __init__(
        self,
        per_rank_views: Sequence[Sequence[Sample]],
        config: OdbConfig,
        *,
        collective: LoopbackCollective | None = None,
        round_margin: int = 64,
        source: ViewSource | None = None,
        quota_hint: int | None = None,
    ) -> None:
        world = len(per_rank_views)
        if world == 0:
            raise ValueError("need at least one rank")
        quotas = {len(v) for v in per_rank_views}
        self.equal_quota = len(quotas) == 1
        self.config = config
        self.collective = collective or LoopbackCollective(world)
        self.source = source
        self.ranks = [
            RankRuntime(r, views, config, source=source)
            for r, views in enumerate(per_rank_views)
        ]
        self.records: list[RoundRecord] = []
        self._round_index = 0
        # Theorem 4 envelope: q + O(D) rounds. The constant in O(D) covers
        # drain-rate-1 stragglers (one view per round) plus slack.  A lazy
        # source with a lookahead tighter than the depth envelope can throttle
        # fetches to O(lookahead/W) views per rank per round, so the streaming
        # executor widens round_margin accordingly (stream/executor.py).
        q = quota_hint
        if q is None:
            q = max(len(v) for v in per_rank_views) if per_rank_views else 0
        self.max_rounds = q + config.depth + round_margin
        # -- telemetry (DESIGN.md §13) ------------------------------------
        # record_telemetry is cleared for audit-only replays (the offline
        # reference continuation in EpochRunner) so rounds that never deliver
        # steps don't pollute the live counters.  on_round lets an owner (the
        # streaming executor's RoundTimeline) absorb each RoundRecord.
        self.record_telemetry = True
        self.on_round: Callable[[RoundRecord], None] | None = None
        self._m_rounds = obs.counter(
            "odb_protocol_rounds_total", help="DGAP outer protocol rounds run"
        )
        self._m_emitted = obs.counter(
            "odb_protocol_emitted_views_total",
            help="sampler views emitted by protocol rounds",
        )
        self._m_round_dur = obs.histogram(
            "odb_protocol_round_duration_seconds",
            buckets=obs.ROUND_DURATION_BUCKETS,
            help="wall time of one protocol round",
            unit="seconds",
        )

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    def potential(self) -> int:
        """Lyapunov Φ = M - Σ|E_r| (App. C.2)."""
        return sum(len(r.pending) + len(r.worker_queue) + len(r.buffer) for r in self.ranks)

    def check_no_leak(self, expected_total: int | None = None) -> None:
        """Lemma 1: R ⊎ Q ⊎ B ⊎ E == admitted views at every round, per rank.

        Offline, ``admitted`` is frozen at construction so this is the classic
        conservation check against the shard size; with a lazy source it grows
        as views are admitted, and conservation must hold against the running
        total (views in flight inside the admission window are not yet the
        engine's responsibility).
        """
        if expected_total is None:
            expected_total = sum(r.admitted for r in self.ranks)
        total = sum(r.total_views for r in self.ranks)
        if total != expected_total:
            raise AssertionError(
                f"No-Leak invariant violated: {total} != {expected_total}"
            )

    # -- one outer round -----------------------------------------------------------
    def run_round(self) -> RoundRecord:
        round_t0 = time.perf_counter()
        cfg = self.config
        # Phase 1: fetch/drain on every unfinished rank.
        for rank in self.ranks:
            if not rank.local_finished:
                rank.fetch_and_drain()

        # Phase 2: candidate groups + primary all_gather payloads (Lemma 3:
        # one unconditional gather per round, on every rank).  With a sharded
        # admission window (DESIGN.md §16) each rank's payload also carries
        # its host window's per-rank summary, so group formation and quota
        # closure downstream observe GLOBAL admission state — the distributed
        # deployment's only cross-host window channel.
        candidates: list[list[Group]] = []

        def payload(r: int):
            groups = [] if self.ranks[r].local_finished else self.ranks[r].candidate_groups()
            candidates.append(groups)
            status = -1 if self.ranks[r].local_finished else self.ranks[r].status_code(groups)
            sizes = [g.size for g in groups]
            tokens = [g.real_tokens for g in groups]
            p = {
                "idx_budget": self.ranks[r].idx_budget,
                "n_groups": status,
                "sizes": sizes,
                "tokens": tokens,
            }
            if self.source is not None:
                shard = self.source.shard_state(r)
                if shard is not None:
                    p["window"] = shard
            return p

        gathered = self.collective.gather_round(payload)
        statuses = tuple(p["n_groups"] for p in gathered)
        idx_budgets = tuple(p["idx_budget"] for p in gathered)
        if self.source is not None:
            window_states = [p.get("window") for p in gathered]
            if any(ws is not None for ws in window_states):
                self.source.absorb_gathered(window_states)

        # Phase 3: alignment target over active ranks (identical on all ranks:
        # pure function of the gathered tensor).
        states = [
            RankAlignmentState(
                groups=tuple(candidates[r]),
                capacity=self.ranks[r].free_slots,
                buffered=len(self.ranks[r].buffer),
            )
            for r in range(self.world_size)
        ]
        active_states = [s for s in states if s.group_count > 0]
        target = alignment_target(active_states) if active_states else 0
        skip_output = target == 0

        emitted_views = 0
        alignment_noop = True
        if not skip_output:
            for r, state in enumerate(states):
                if state.group_count > 0 and state.capacity > 0:
                    result = align_rank(state, target)
                    if result.splits or result.overflowed_groups:
                        alignment_noop = False
                    before = self.ranks[r].counters.emitted_views
                    self.ranks[r].emit_aligned(result, target)
                    emitted_views += self.ranks[r].counters.emitted_views - before
                else:
                    # Inactive (or zero-capacity) rank: pad with IDLE to keep
                    # per-step positions aligned.
                    alignment_noop = False
                    empty = AlignmentResult(
                        groups=(), recirculated=(), splits=0, overflowed_groups=0
                    )
                    self.ranks[r].emit_aligned(empty, target)

        # Phase 4 (optional, deterministic predicate φ over the shared
        # tensors): second gather re-broadcasting post-alignment token counts
        # for exact token-level loss scaling (App. B).  All-or-none (Lemma 3).
        second = bool(
            cfg.exact_token_scaling and not skip_output and not alignment_noop
        )
        if second:
            self.collective.gather_round(
                lambda r: {
                    "post_tokens": [
                        (0 if g is IDLE else g.real_tokens)
                        for g in list(self.ranks[r].out_queue)[-target:]
                    ]
                },
                tag="secondary",
            )

        # Phase 5: join-mode local-finish advertisement for the *next* round.
        for rank in self.ranks:
            if rank.no_more_input and not rank.buffer:
                rank.local_finished = True

        duration_s = time.perf_counter() - round_t0
        record = RoundRecord(
            round_index=self._round_index,
            statuses=statuses,
            idx_budgets=idx_budgets,
            target=target,
            emitted_views=emitted_views,
            skip_output=skip_output,
            second_gather=second,
            potential=self.potential(),
            duration_s=duration_s,
        )
        self.records.append(record)
        self._round_index += 1
        if self.record_telemetry:
            self._m_rounds.inc()
            self._m_emitted.inc(emitted_views)
            self._m_round_dur.observe(duration_s)
            obs.default_tracer().complete(
                "dgap/round",
                round_t0,
                duration_s,
                cat="protocol",
                round=record.round_index,
                target=target,
                emitted_views=emitted_views,
            )
            if self.on_round is not None:
                self.on_round(record)
        return record

    # -- full logical iteration ---------------------------------------------------
    def run_iteration(self) -> IterationResult:
        """Run rounds until the mode-specific termination predicate fires."""
        start_round = self._round_index
        emitted_start = sum(r.emitted_count for r in self.ranks)
        terminated_by = ""
        while True:
            if self._round_index - start_round > self.max_rounds:
                raise BoundedTerminationError(
                    f"exceeded Theorem-4 envelope of {self.max_rounds} rounds "
                    f"(Φ={self.potential()})"
                )
            record = self.run_round()
            self.check_no_leak()
            if self.config.join_mode:
                if all(s == -1 for s in record.statuses):
                    terminated_by = "join_all_finished"
                    break
            else:
                if any(s == -1 for s in record.statuses):
                    terminated_by = "nonjoin_any_finished"
                    break
        abandoned = sum(r.outstanding for r in self.ranks)
        emitted = sum(r.emitted_count for r in self.ranks) - emitted_start
        return IterationResult(
            rounds=self._round_index - start_round,
            emitted_views=emitted,
            abandoned_views=abandoned,
            records=self.records[start_round:],
            terminated_by=terminated_by,
        )

    # -- trainer-facing step stream ------------------------------------------------
    def aligned_steps(self) -> Iterator[list[Group | None]]:
        """Yield step-aligned per-rank batches (Group or IDLE) in order.

        Queue lengths are equal across ranks after every round by
        construction (every round appends exactly ``target`` entries to every
        rank's queue), so the zip below is the SPMD step schedule.
        """
        lengths = {len(r.out_queue) for r in self.ranks}
        if len(lengths) != 1:
            raise ProtocolDesyncError(f"unaligned output queues: {lengths}")
        steps = lengths.pop()
        for _ in range(steps):
            yield [r.out_queue.popleft() for r in self.ranks]

    def pop_aligned_steps(self) -> list[list[Group | None]]:
        """Drain every currently-queued aligned step (used by EpochRunner to
        hand steps out as soon as a round produces them)."""
        return list(self.aligned_steps())


# ---------------------------------------------------------------------------------
# Epoch-level runners (trainer-side control logic).
# ---------------------------------------------------------------------------------


@dataclasses.dataclass
class EpochAudit:
    """Terminal audit quantities of §C.5/C.6 and Theorems 1/2."""

    dataset_identities: int  # N
    world_size: int  # W
    sampler_views: int  # M = W * ceil(N/W)
    emitted_views: int  # S_emit (trainer-side cumulative)
    emitted_identities: int  # |∪_r IDs_r|
    surplus_emits: int  # Σ|emits_r| - N  (vs deterministic padding P)
    logical_iterations: int
    rounds: int  # protocol rounds actually run
    rounds_offline: int  # rounds the offline reference engine would have run
    abandoned_views_per_iteration: list[int]
    eta_quota: float  # max(0, 1 - S_emit / N)          (Thm 2)
    eta_identity: float  # 1 - |∪ IDs| / N              (App. C.6)
    terminal_epoch: float  # S_emit / N
    # Quarantine component X (DESIGN.md §15): realization failures moved out
    # of the sampler order instead of wedging a round.  Views counts every
    # event (an identity can re-fail across non-join iterations); identities
    # is the coverage-relevant set size.
    quarantined_views: int = 0
    quarantined_identities: int = 0

    @property
    def padding_views(self) -> int:
        return self.sampler_views - self.dataset_identities  # P = M - N

    @property
    def coverage_accounted(self) -> bool:
        """Theorem-1 rail under faults: every identity either emitted or
        explicitly quarantined — no silent coverage gap."""
        return (
            self.emitted_identities + self.quarantined_identities
            >= self.dataset_identities
        )


class EpochRunner:
    """Resumable ``step()``-at-a-time epoch engine (Theorems 1/2 control).

    Owns the trainer-side chaining logic that used to live inside the
    monolithic ``run_epoch`` loop: logical-iteration construction, join /
    non-join termination, quota crossing, and the identity/emit accounting
    that becomes the :class:`EpochAudit`.  Each ``step()`` call returns the
    next aligned per-rank step (or ``None`` once the epoch is complete), so a
    trainer — or the streaming executor — can interleave protocol progress
    with compute and checkpoint between any two steps.

    Two scheduling modes:

      * ``incremental=False`` — exact ``run_epoch`` semantics: each logical
        iteration's rounds run to termination before its steps are delivered
        (the offline regime; audits are bit-identical to the historical
        implementation);
      * ``incremental=True`` — rounds interleave with delivery: after every
        protocol round, newly aligned steps are handed out immediately, so
        the first train step starts after O(D) admitted views instead of
        after the whole epoch's rounds.  In non-join mode the quota crossing
        also stops round execution eagerly (the remaining fetched-but-unused
        views are counted as abandoned, Lemma 4).  The delivered *step
        sequence* is identical in both modes whenever ``output_capacity`` is
        unbounded, because rounds are a pure function of engine state that
        popping the output queues cannot influence.

    ``make_engine(iteration)`` builds the protocol engine for one logical
    iteration; with a lazy :class:`ViewSource` attached, views (and their
    realized lengths) are admitted on demand — see ``repro/stream``.
    """

    def __init__(
        self,
        make_engine: Callable[[int], "OdbProtocolEngine"],
        dataset_identities: int,
        config: OdbConfig,
        *,
        world_size: int,
        max_logical_iterations: int = 64,
        incremental: bool = False,
    ) -> None:
        self.make_engine = make_engine
        self.n = dataset_identities
        self.config = config
        self.world = world_size
        self.quota = world_size * math.ceil(dataset_identities / world_size)
        self.max_logical_iterations = max_logical_iterations
        self.incremental = incremental
        # -- resumable accounting state (serialized by stream/state.py) -----
        self.iteration = 0
        self.emitted_total = 0
        self.emitted_ids: set[int] = set()
        # Quarantine component X (§15): identities whose realization failed
        # (fed by the admission window's on_quarantine hook) plus the event
        # count.  In non-join mode the Theorem-2 quota shrinks by |X| — a
        # deterministically poisoned identity can never be emitted, so the
        # raw quota would chain iterations forever.
        self.quarantined_ids: set[int] = set()
        self.quarantined_views = 0
        self.rounds = 0
        # Incremental non-join stops rounds at the quota crossing (the eager
        # win); the offline engine would have kept going until a rank
        # advertised -1.  The continuation rounds are counted here so the
        # audit can report both (ROADMAP "round trimming" item).
        self.rounds_offline_extra = 0
        self.abandoned: list[int] = []
        self.steps_delivered = 0
        self.terminated_by: str | None = None
        self._ready: collections.deque[list[Group | None]] = collections.deque()
        self._engine: OdbProtocolEngine | None = None
        self._iteration_open = False
        self._iter_rounds = 0
        self._done = False
        # Telemetry hook: called as on_closure(terminated_by, iteration,
        # iteration_rounds) whenever a logical iteration's rounds terminate
        # (the streaming executor wires its RoundTimeline here).
        self.on_closure: Callable[[str, int, int], None] | None = None

    @property
    def done(self) -> bool:
        return self._done

    @property
    def engine(self) -> "OdbProtocolEngine | None":
        return self._engine

    # -- quarantine accounting (§15) -------------------------------------------
    def note_quarantine(self, identity: int) -> None:
        """Record one realization failure moved to component X."""
        self.quarantined_ids.add(identity)
        self.quarantined_views += 1

    @property
    def effective_quota(self) -> int:
        """Theorem-2 quota minus quarantined identities (they cannot emit)."""
        return max(0, self.n - len(self.quarantined_ids))

    # -- iteration lifecycle --------------------------------------------------
    def _open_iteration(self) -> None:
        self._engine = self.make_engine(self.iteration)
        self._iteration_open = True
        self._iter_rounds = 0

    def _close_iteration(self) -> None:
        """Bookkeeping after an iteration's steps are fully delivered."""
        self.iteration += 1
        self._iteration_open = False
        self._engine = None
        if self.config.join_mode:
            self.terminated_by = self.terminated_by or "join_all_finished"
            self._done = True
        elif self.emitted_total >= self.effective_quota:
            self._done = True
        elif self.iteration >= self.max_logical_iterations:
            raise BoundedTerminationError(
                f"quota not closed after {self.iteration} logical iterations "
                f"({self.emitted_total}/{self.n})"
            )

    def _finish_iteration_rounds(self, terminated_by: str) -> None:
        """The termination predicate fired: absorb round/abandon accounting."""
        assert self._engine is not None
        self.rounds += self._iter_rounds
        self.abandoned.append(sum(r.outstanding for r in self._engine.ranks))
        obs.instant(
            "dgap/closure",
            cat="protocol",
            event=terminated_by,
            iteration=self.iteration,
            iteration_rounds=self._iter_rounds,
        )
        if self.on_closure is not None:
            self.on_closure(terminated_by, self.iteration, self._iter_rounds)
        if terminated_by == "nonjoin_quota_crossed":
            # The eager stop trimmed the iteration's tail rounds.  Replay the
            # remainder on the (about-to-be-dropped) engine — rounds are a
            # pure function of engine state, and with output_capacity
            # unbounded the undrained queues cannot change them — so the
            # audit also reports what the offline engine would have run.
            # Grouping/alignment only: no padding, no compute, no delivery.
            engine = self._engine
            # Audit-only rounds: keep them out of the live round counters.
            engine.record_telemetry = False
            engine.on_round = None
            extra = 0
            while True:
                if self._iter_rounds + extra > engine.max_rounds:
                    raise BoundedTerminationError(
                        f"offline-reference replay exceeded Theorem-4 "
                        f"envelope of {engine.max_rounds} rounds"
                    )
                record = engine.run_round()
                extra += 1
                if any(s == -1 for s in record.statuses):
                    break
            self.rounds_offline_extra += extra
        self.terminated_by = terminated_by
        self._engine = None  # rounds done; steps may still sit in _ready

    # -- batch mode: run a whole iteration's rounds, then deliver -------------
    def _advance_batch(self) -> None:
        if self._iteration_open:
            self._close_iteration()
            if self._done:
                return
        self._open_iteration()
        assert self._engine is not None
        result = self._engine.run_iteration()
        self._iter_rounds = result.rounds
        ready = self._engine.pop_aligned_steps()
        self._finish_iteration_rounds(result.terminated_by)
        self._ready.extend(ready)

    # -- incremental mode: one protocol round per pass ------------------------
    def _advance_incremental(self) -> None:
        while not self._ready and not self._done:
            if self._engine is None:
                if self._iteration_open:
                    self._close_iteration()
                    continue
                self._open_iteration()
            engine = self._engine
            assert engine is not None
            if self._iter_rounds > engine.max_rounds:
                raise BoundedTerminationError(
                    f"exceeded Theorem-4 envelope of {engine.max_rounds} "
                    f"rounds (Φ={engine.potential()})"
                )
            record = engine.run_round()
            engine.check_no_leak()
            self._iter_rounds += 1
            self._ready.extend(engine.pop_aligned_steps())
            if self.config.join_mode:
                if all(s == -1 for s in record.statuses):
                    self._finish_iteration_rounds("join_all_finished")
            elif any(s == -1 for s in record.statuses):
                self._finish_iteration_rounds("nonjoin_any_finished")

    # -- delivery -------------------------------------------------------------
    def _account(self, step: list[Group | None]) -> None:
        real = [g for g in step if g is not IDLE]
        self.emitted_total += sum(g.size for g in real)
        for g in real:
            self.emitted_ids.update(s.identity for s in g.samples)
        self.steps_delivered += 1
        if not self.config.join_mode and self.emitted_total >= self.effective_quota:
            # Theorem 2: the final quota crossing happens inside one aligned
            # step, so S_emit - N <= S_max.  Stop delivering; abandon the
            # rest of the iteration (rounds + queued steps).
            if self._engine is not None:
                self._finish_iteration_rounds("nonjoin_quota_crossed")
            self._ready.clear()
            if self._iteration_open:
                # Guarded so a requeued crossing step re-delivered after a
                # prefetch rollback doesn't close the iteration twice.
                self.iteration += 1
                self._iteration_open = False
            self._done = True

    def requeue(self, steps: Sequence[list[Group | None]]) -> None:
        """Roll delivered-but-unconsumed steps back into the ready queue.

        The prefetch path delivers steps into a staging queue ahead of the
        consumer; when the consumer abandons the epoch, the staged tail is
        pushed back (in order) so a checkpoint taken afterwards reflects the
        consumer's frontier exactly.  Emit counts are reversed; emitted
        identities are not — the identical steps re-deliver the identical
        identities, so the coverage union is unchanged.
        """
        for step in reversed(list(steps)):
            real = [g for g in step if g is not IDLE]
            self.emitted_total -= sum(g.size for g in real)
            self.steps_delivered -= 1
            self._ready.appendleft(step)

    def step(self) -> list[Group | None] | None:
        """Return the next aligned per-rank step, or None when complete."""
        while not self._ready:
            if self._done:
                return None
            if self.incremental:
                self._advance_incremental()
            else:
                self._advance_batch()
        out = self._ready.popleft()
        self._account(out)
        return out

    def steps(self) -> Iterator[list[Group | None]]:
        while True:
            s = self.step()
            if s is None:
                return
            yield s

    def audit(self) -> EpochAudit:
        n = self.n
        return EpochAudit(
            dataset_identities=n,
            world_size=self.world,
            sampler_views=self.quota,
            emitted_views=self.emitted_total,
            emitted_identities=len(self.emitted_ids),
            surplus_emits=self.emitted_total - n,
            logical_iterations=self.iteration,
            rounds=self.rounds,
            rounds_offline=self.rounds + self.rounds_offline_extra,
            abandoned_views_per_iteration=self.abandoned,
            eta_quota=max(0.0, 1.0 - self.emitted_total / n) if n else 0.0,
            eta_identity=1.0 - len(self.emitted_ids) / n if n else 0.0,
            terminal_epoch=self.emitted_total / n if n else 0.0,
            quarantined_views=self.quarantined_views,
            quarantined_identities=len(self.quarantined_ids),
        )


def run_epoch(
    make_views: Callable[[int], Sequence[Sequence[Sample]]],
    dataset_identities: int,
    config: OdbConfig,
    *,
    max_logical_iterations: int = 64,
    on_step: Callable[[list[Group | None]], None] | None = None,
    drain_rates: Sequence[int | None] | None = None,
) -> EpochAudit:
    """Run one training epoch's worth of sampler quota through the protocol.

    Thin wrapper over :class:`EpochRunner` (batch mode) preserving the
    historical contract: ``make_views(iteration)`` returns the per-rank
    sampler-view lists for logical iteration ``iteration`` (re-shuffled per
    iteration, mirroring the re-seeded DistributedSampler).  In join mode a
    single logical iteration emits the full multiset M (Theorem 1).  In
    non-join mode iterations are chained until ``S_emit >= N`` (Theorem 2).
    """
    world = len(make_views(0))

    def make_engine(iteration: int) -> OdbProtocolEngine:
        engine = OdbProtocolEngine(make_views(iteration), config)
        if drain_rates is not None:
            for rank, rate in zip(engine.ranks, drain_rates):
                rank.drain_rate = rate
        return engine

    runner = EpochRunner(
        make_engine,
        dataset_identities,
        config,
        world_size=world,
        max_logical_iterations=max_logical_iterations,
    )
    for step in runner.steps():
        if on_step is not None:
            on_step(step)
    return runner.audit()
