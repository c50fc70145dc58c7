"""Bounded-lookahead admission window (DESIGN.md §9.1, §16).

The paper's observability constraint: a sample's true cost (its realized
token length) exists only *after* the online pipeline has run.  The offline
loader sidesteps this by calling ``realize_lengths`` over the whole dataset
before scheduling — exactly the length-cache regime ODB rules out.  The
``AdmissionWindow`` restores the online causal order:

  * the *shuffle order* is computed up front from identities alone (the
    DistributedSampler never observes lengths, App. C.1), so the padded view
    order of size ``M = W·ceil(N/W)`` is known without any pipeline work;
  * lengths are realized through ``run_pipeline`` one view at a time, only
    when the view is admitted into the window;
  * at most ``lookahead`` realized-but-undelivered views are resident at any
    instant — the engine pulls via the :class:`repro_torch.core.protocol.ViewSource`
    interface and realization never runs ahead of consumption by more than
    the lookahead budget (backpressure by refusal, not by blocking).

Window state is **per-rank decomposed** (DESIGN.md §16): stride-sharding
assigns rank ``r`` the order positions ``r, r+W, r+2W, …``, and each rank
owns an independent sub-cursor over its own positions plus a lookahead
sub-budget ``L_r`` with ``Σ_r L_r = lookahead``.  Realized length is a pure
function of identity, so the per-rank delivered sequence is invariant to
*when* other ranks' positions are realized — which is exactly what makes the
window distributable: a multi-host deployment runs one :class:`ShardedWindow`
per host over that host's rank block, and the union of per-rank states is
bit-identical to the single-process window's, for any host count.

Determinism: given (records, policy, pipeline_epoch, spec, shuffle_epoch),
admission order, view ids and realized lengths are identical to the offline
``realize_lengths`` + ``shard_views`` pair — with ``lookahead >= M`` no
sub-budget ever binds and the downstream step schedule is bit-for-bit the
eager one (tests/test_stream.py).

The cursor/staging/backpressure machinery is independent of *what* is being
realized, so it lives in :class:`BoundedWindow` — the epoch window below
binds it to the sampler order + ``run_pipeline``, and the serving engine
binds the same mechanics to a live request queue
(``repro_torch.serve.requests.RequestWindow``), where "realization" is the
tokenizer stamping a request's true token cost (DESIGN.md §12).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

from repro_torch import obs
from repro_torch.core.grouping import Sample
from repro_torch.core.protocol import ViewSource
from repro_torch.data.pipeline import PipelinePolicy, RawRecord, run_pipeline
from repro_torch.data.sampler import SamplerSpec, global_view_order


def split_lookahead(lookahead: int, world_size: int) -> list[int]:
    """Per-rank lookahead sub-budgets ``L_r`` with ``Σ L_r = lookahead``.

    The remainder spreads over the first ``lookahead % W`` ranks, so with
    ``lookahead >= world_size`` every rank holds at least one slot — the
    per-rank liveness floor that keeps a take() from starving.  Budgets are a
    pure function of the *global* (lookahead, world_size) pair, never of the
    host partition, which is what makes the throttling schedule identical
    across host counts.
    """
    base, extra = divmod(lookahead, world_size)
    return [base + (1 if r < extra else 0) for r in range(world_size)]


def host_rank_blocks(world_size: int, num_hosts: int) -> list[tuple[int, ...]]:
    """Contiguous rank blocks per host, the deployment layout where each
    host's local devices are its rank block.

    ``W % P == 0`` gives the equal partition (host ``h`` owns ranks
    ``[h·W/P, (h+1)·W/P)``).  Uneven world sizes spread the remainder over
    the first ``W % P`` hosts — the same rule as :func:`split_lookahead` —
    so blocks stay contiguous and sizes differ by at most one:
    ``(W=6, P=4) -> (0,1) (2,3) (4,) (5,)`` and
    ``(W=5, P=2) -> (0,1,2) (3,4)``.  Every host must own at least one
    rank, so ``P > W`` (an empty block) stays an error.
    """
    if num_hosts <= 0:
        raise ValueError(f"num_hosts must be positive, got {num_hosts}")
    if num_hosts > world_size:
        raise ValueError(
            f"num_hosts {num_hosts} > world_size {world_size}: "
            "some host would own no rank"
        )
    base, extra = divmod(world_size, num_hosts)
    blocks: list[tuple[int, ...]] = []
    start = 0
    for h in range(num_hosts):
        size = base + (1 if h < extra else 0)
        blocks.append(tuple(range(start, start + size)))
        start += size
    return blocks


@dataclasses.dataclass
class WindowStats:
    """Observability of the admission window (drives tests + benchmarks)."""

    realized: int = 0  # total views pushed through run_pipeline
    delivered: int = 0  # total views handed to the engine
    peak_resident: int = 0  # max realized-but-undelivered at any instant
    refusals: int = 0  # take() calls throttled by the lookahead budget
    quarantined: int = 0  # realization failures moved to component X (§15)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class QuarantineLedger:
    """Shared budget + records of the quarantine component ``X`` (§15, §16).

    One ledger per logical iteration.  In a sharded deployment every host
    window of the iteration shares one ledger (in-process) or merges remote
    charge sets through the gather payload (real multi-host), so the budget
    charges each distinct sample exactly once no matter which host observes
    the failure first — the padded order repeats an identity on several
    ranks, and those ranks may live on different hosts.
    """

    def __init__(self, budget: int, exempt: frozenset[int] = frozenset()) -> None:
        self.budget = budget
        # Identities already quarantined earlier in the epoch (a non-join
        # catch-up iteration or a resumed run re-walks the order and meets
        # the same deterministically-failing sample again): re-quarantining
        # them is free — the budget charges each distinct sample once.
        self.exempt = frozenset(exempt)
        self.charged = 0
        self.charged_ids: set[int] = set()
        self.records: list[dict] = []

    def admit_failure(
        self, position: int, identity: int, exc: BaseException
    ) -> bool:
        """Charge one realization failure; False when the budget is spent."""
        exempt = identity >= 0 and (
            identity in self.exempt or identity in self.charged_ids
        )
        if not exempt and self.charged >= self.budget:
            return False
        if not exempt:
            self.charged += 1
            if identity >= 0:
                self.charged_ids.add(identity)
        self.records.append(
            {
                "position": position,
                "identity": identity,
                "error": f"{type(exc).__name__}: {exc}",
            }
        )
        return True

    def load(self, records: Sequence[dict]) -> None:
        self.records = [dict(q) for q in records]
        self.charged_ids = {
            q["identity"]
            for q in self.records
            if q["identity"] >= 0 and q["identity"] not in self.exempt
        }
        self.charged = len(self.charged_ids) + sum(
            1 for q in self.records if q["identity"] < 0
        )


class BoundedWindow(ViewSource):
    """Lookahead-bounded realization over a (possibly growing) position order.

    Subclasses define the order: :meth:`order_size` (how many positions exist
    right now), :meth:`realize` (pay the realization cost for one position and
    return its :class:`Sample`), and :meth:`order_open` (may more positions
    arrive later? — always ``False`` for an epoch, ``True`` for a live
    request queue until it is closed).  The base class owns the per-rank
    decomposed state (stride-sharding: rank ``r`` owns positions
    ``r, r+W, r+2W, …``): one sub-cursor, one staging deque and one lookahead
    sub-budget per rank, with the backpressure contract that at most
    ``Σ_r L_r = lookahead`` realized-but-undelivered samples are resident at
    any instant (backpressure by refusal, not by blocking).

    ``lookahead`` must be at least ``world_size`` — below that, some rank's
    sub-budget would be zero and a take() for it could never stage a view.

    Sample quarantine (DESIGN.md §15): a position whose ``realize`` raises
    is moved to the accounted component ``X`` — the owning rank's cursor
    advances past it, nothing is staged, and the failure lands in the
    :class:`QuarantineLedger` — up to the ledger's budget; beyond it (or
    with the strict default of 0) the exception propagates.
    ``on_quarantine`` lets an owner (the stream executor) fold each event
    into the epoch-level Lemma-1 accounting; ``on_remote_quarantine`` is the
    §16 merge path — identities another host quarantined arrive through
    :meth:`absorb_gathered` so non-join quota closure shrinks by the
    *global* ``|X|``, never the host-local one.
    """

    def __init__(
        self,
        world_size: int,
        lookahead: int,
        *,
        max_quarantine: int = 0,
        quarantine_exempt: frozenset[int] = frozenset(),
        ledger: QuarantineLedger | None = None,
    ) -> None:
        if lookahead < world_size:
            raise ValueError(
                f"lookahead {lookahead} < world_size {world_size}: "
                "some rank's lookahead sub-budget would be zero"
            )
        self.world_size = world_size
        self.lookahead = lookahead
        self.rank_lookahead = split_lookahead(lookahead, world_size)
        self.ledger = (
            ledger
            if ledger is not None
            else QuarantineLedger(max_quarantine, quarantine_exempt)
        )
        self.on_quarantine: Callable[[int, int, BaseException], None] | None = None
        self.on_remote_quarantine: Callable[[int], None] | None = None
        # Identities learned quarantined from OTHER hosts' gather payloads
        # (§16) — informational here (the owning host charged the ledger),
        # but load-bearing for closure when ledgers are not shared.
        self.remote_quarantined: set[int] = set()
        self.cursors = [0] * world_size  # per-rank owned-position sub-cursors
        self.staged: list[collections.deque[Sample]] = [
            collections.deque() for _ in range(world_size)
        ]
        self.delivered_per_rank = [0] * world_size
        self.stats = WindowStats()
        # Telemetry (DESIGN.md §13): instruments cached at construction so the
        # per-view hot path is one attribute call on a plain-slot object.
        self._m_realized = obs.counter(
            "odb_window_realized_total", help="views pushed through realization"
        )
        self._m_delivered = obs.counter(
            "odb_window_delivered_total", help="views handed to the engine"
        )
        self._m_refusals = obs.counter(
            "odb_window_refusals_total",
            help="take() calls throttled by the lookahead budget",
        )
        self._m_resident = obs.gauge(
            "odb_window_resident", help="realized-but-undelivered views resident now"
        )
        self._m_quarantined = obs.counter(
            "odb_fault_quarantined_total",
            help="views moved to the quarantine component X on realization failure",
        )

    # -- quarantine ledger views ----------------------------------------------
    @property
    def max_quarantine(self) -> int:
        return self.ledger.budget

    @property
    def quarantine_exempt(self) -> frozenset[int]:
        return self.ledger.exempt

    @property
    def quarantined(self) -> list[dict]:
        """Component X of the extended No-Leak partition (R, Q, B, E, X)."""
        return self.ledger.records

    # -- per-rank decomposition -------------------------------------------------
    @property
    def resident(self) -> int:
        """Realized-but-undelivered views resident across all ranks."""
        return sum(len(dq) for dq in self.staged)

    def rank_position(self, rank: int) -> int:
        """Global order position the rank's sub-cursor points at."""
        return rank + self.cursors[rank] * self.world_size

    def rank_order_size(self, rank: int) -> int:
        """Order positions owned by ``rank`` under stride-sharding."""
        size = self.order_size()
        if rank >= size:
            return 0
        return (size - 1 - rank) // self.world_size + 1

    # -- order interface (subclass responsibility) -----------------------------
    def order_size(self) -> int:  # pragma: no cover
        """Number of positions currently in the order (may grow)."""
        raise NotImplementedError

    def realize(self, position: int) -> Sample:  # pragma: no cover
        """Run the realization pipeline for one position."""
        raise NotImplementedError

    def order_open(self) -> bool:
        """May positions beyond ``order_size()`` still arrive?"""
        return False

    def quarantine_identity(self, position: int) -> int:
        """Identity behind ``position`` for quarantine accounting (-1 = n/a)."""
        return -1

    # -- admission -------------------------------------------------------------
    def _admit_one(self, rank: int) -> None:
        position = self.rank_position(rank)
        try:
            sample = self.realize(position)
        except Exception as exc:
            identity = self.quarantine_identity(position)
            if not self.ledger.admit_failure(position, identity, exc):
                raise
            # The rank's cursor advances past the position WITHOUT staging
            # it: the view leaves the sampler order for component X, so
            # take() keeps making progress and no rank ever waits on the
            # poison sample.
            self.cursors[rank] += 1
            self.stats.quarantined += 1
            self._m_quarantined.inc()
            self._m_resident.set(self.resident)
            if self.on_quarantine is not None:
                self.on_quarantine(position, identity, exc)
            return
        self.staged[rank].append(sample)
        self.cursors[rank] += 1
        self.stats.realized += 1
        self.stats.peak_resident = max(self.stats.peak_resident, self.resident)
        self._m_realized.inc()
        self._m_resident.set(self.resident)

    # -- ViewSource interface --------------------------------------------------
    def take(self, rank: int, k: int) -> list[Sample]:
        dq = self.staged[rank]
        throttled = False
        while len(dq) < k and self.cursors[rank] < self.rank_order_size(rank):
            if len(dq) >= self.rank_lookahead[rank]:
                throttled = True
                break
            self._admit_one(rank)
        if throttled and len(dq) < k:
            self.stats.refusals += 1
            self._m_refusals.inc()
        out: list[Sample] = []
        while dq and len(out) < k:
            out.append(dq.popleft())
        self.delivered_per_rank[rank] += len(out)
        self.stats.delivered += len(out)
        self._m_delivered.inc(len(out))
        self._m_resident.set(self.resident)
        return out

    def exhausted(self, rank: int) -> bool:
        return (
            not self.order_open()
            and self.cursors[rank] >= self.rank_order_size(rank)
            and not self.staged[rank]
        )

    def remaining(self, rank: int) -> int:
        """Samples not yet delivered to ``rank`` (staged + beyond the cursor).

        Exact regardless of realized lengths: stride-sharding makes the count
        of positions owned by ``rank`` a pure function of (order size, W), so
        ``remaining = staged + owned - admitted`` — invariant to admission
        order *and* to the host partition (a staged view merely moved from
        the future term to the staged term).  For the epoch window this
        equals ``per_rank_quota - delivered``.
        """
        future = max(0, self.rank_order_size(rank) - self.cursors[rank])
        return len(self.staged[rank]) + future

    # -- §16 payload fold -------------------------------------------------------
    def shard_state(self, rank: int) -> dict:
        """Per-rank window summary folded into the round gather payload.

        Carries the owning host id, the rank's sub-cursor, staged depth and
        delivery count, the host-wide resident total, and the (budget-bounded)
        charged quarantine identities — everything another host needs to
        reconstruct global admission state and the merged ``|X|``.
        """
        return {
            "host": getattr(self, "host", 0),
            "cursor": self.cursors[rank],
            "staged": len(self.staged[rank]),
            "delivered": self.delivered_per_rank[rank],
            "resident": self.resident,
            "quarantined_ids": sorted(self.ledger.charged_ids),
        }

    def absorb_gathered(self, states: Sequence[dict | None]) -> None:
        """Merge other hosts' shard summaries (post-gather, every round).

        Non-join quota closure must shrink by the *global* quarantine
        component: identities charged on another host's ledger join
        ``remote_quarantined`` and fire ``on_remote_quarantine`` exactly
        once, so the epoch runner's ``effective_quota`` sees merged ``|X|``
        rather than the host-local one.  Idempotent when hosts share one
        ledger (the in-process simulated lane).
        """
        for state in states:
            if not state:
                continue
            for identity in state.get("quarantined_ids", ()):
                if (
                    identity in self.ledger.charged_ids
                    or identity in self.remote_quarantined
                ):
                    continue
                self.remote_quarantined.add(identity)
                if self.on_remote_quarantine is not None:
                    self.on_remote_quarantine(identity)


class AdmissionWindow(BoundedWindow):
    """Incremental, lookahead-bounded realization of one logical iteration.

    One window corresponds to one logical sampler iteration (one shuffled,
    padded view order, fixed at construction): realization is
    ``run_pipeline`` over the identity at each order position.
    """

    def __init__(
        self,
        records: list[RawRecord],
        policy: PipelinePolicy,
        spec: SamplerSpec,
        *,
        shuffle_epoch: int,
        pipeline_epoch: int = 0,
        lookahead: int | None = None,
        view_id_base: int = 0,
        max_quarantine: int = 0,
        quarantine_exempt: frozenset[int] = frozenset(),
        ledger: QuarantineLedger | None = None,
    ) -> None:
        if lookahead is None:
            lookahead = spec.total_views
        super().__init__(
            spec.world_size,
            lookahead,
            max_quarantine=max_quarantine,
            quarantine_exempt=quarantine_exempt,
            ledger=ledger,
        )
        self.records = records
        self.policy = policy
        self.spec = spec
        self.shuffle_epoch = shuffle_epoch
        self.pipeline_epoch = pipeline_epoch
        self.view_id_base = view_id_base
        self.order = global_view_order(spec, shuffle_epoch)  # identities only

    # -- order interface -------------------------------------------------------
    def order_size(self) -> int:
        return len(self.order)

    def realize(self, position: int) -> Sample:
        identity = self.order[position]
        length = run_pipeline(self.records[identity], self.policy, self.pipeline_epoch)
        return Sample(
            view_id=self.view_id_base + position,
            identity=identity,
            length=length,
        )

    def quarantine_identity(self, position: int) -> int:
        return self.order[position]

    # -- checkpointing (stream/state.py) ---------------------------------------
    def state_dict(self) -> dict:
        """Serializable mid-iteration window state (v4 schema).

        Keyed per RANK, never per host: the shuffle order regenerates
        deterministically from (spec, shuffle_epoch), staged views are stored
        explicitly so a resume is exact, and because every field is per-rank
        the same payload restores into any host partition of the same world
        size (DESIGN.md §16 resume-across-host-counts).
        """
        return {
            "cursors": list(self.cursors),
            "view_id_base": self.view_id_base,
            "shuffle_epoch": self.shuffle_epoch,
            "pipeline_epoch": self.pipeline_epoch,
            "lookahead": self.lookahead,
            "staged": [
                [[s.view_id, s.identity, s.length] for s in dq]
                for dq in self.staged
            ],
            "delivered_per_rank": list(self.delivered_per_rank),
            "stats": self.stats.as_dict(),
            "max_quarantine": self.ledger.budget,
            "quarantined": [dict(q) for q in self.ledger.records],
            "remote_quarantined": sorted(self.remote_quarantined),
        }

    def load_state_dict(self, state: dict) -> None:
        self.cursors = list(state["cursors"])
        self.view_id_base = state["view_id_base"]
        self.lookahead = state["lookahead"]
        self.rank_lookahead = split_lookahead(self.lookahead, self.world_size)
        self.ledger.budget = state["max_quarantine"]
        self.ledger.load(state["quarantined"])
        self.remote_quarantined = set(state.get("remote_quarantined", []))
        self.staged = [
            collections.deque(
                Sample(view_id=v, identity=i, length=ln) for v, i, ln in dq
            )
            for dq in state["staged"]
        ]
        self.delivered_per_rank = list(state["delivered_per_rank"])
        self.stats = WindowStats(**state["stats"])


class ShardedWindow(AdmissionWindow):
    """Host-local admission window over the host's rank block (§16).

    Each host of a ``num_hosts``-way deployment runs one of these over the
    *same* deterministic sampler order but serves only its own ranks: the
    per-rank decomposition of :class:`BoundedWindow` means the host never
    needs another host's cursor to make progress, and the union of per-rank
    states across hosts is bit-identical to the single-process window's.
    Lookahead sub-budgets are computed from the global (lookahead, W) pair,
    so throttling is also partition-invariant.

    A take() for a rank outside ``host_ranks`` is a deployment bug (the
    engine routed a foreign rank here) and raises instead of silently
    realizing another host's shard.
    """

    def __init__(
        self,
        records: list[RawRecord],
        policy: PipelinePolicy,
        spec: SamplerSpec,
        *,
        host: int,
        num_hosts: int,
        shuffle_epoch: int,
        pipeline_epoch: int = 0,
        lookahead: int | None = None,
        view_id_base: int = 0,
        max_quarantine: int = 0,
        quarantine_exempt: frozenset[int] = frozenset(),
        ledger: QuarantineLedger | None = None,
    ) -> None:
        blocks = host_rank_blocks(spec.world_size, num_hosts)
        if not 0 <= host < num_hosts:
            raise ValueError(f"host {host} outside [0, {num_hosts})")
        super().__init__(
            records,
            policy,
            spec,
            shuffle_epoch=shuffle_epoch,
            pipeline_epoch=pipeline_epoch,
            lookahead=lookahead,
            view_id_base=view_id_base,
            max_quarantine=max_quarantine,
            quarantine_exempt=quarantine_exempt,
            ledger=ledger,
        )
        self.host = host
        self.num_hosts = num_hosts
        self.host_ranks = blocks[host]
        self._host_rank_set = frozenset(self.host_ranks)

    def _check_rank(self, rank: int) -> None:
        if rank not in self._host_rank_set:
            raise ValueError(
                f"rank {rank} is not served by host {self.host} "
                f"(host ranks {self.host_ranks})"
            )

    def take(self, rank: int, k: int) -> list[Sample]:
        self._check_rank(rank)
        return super().take(rank, k)

    def shard_state(self, rank: int) -> dict:
        self._check_rank(rank)
        return super().shard_state(rank)


class WindowRouter(ViewSource):
    """One engine-facing :class:`ViewSource` over P host windows (§16).

    The in-process simulated multi-host lane: the protocol engine still
    simulates all W ranks in one process, and the router dispatches each
    rank's take/exhausted/remaining/shard_state to the :class:`ShardedWindow`
    owning that rank — exactly the call pattern each host process would see
    in a real deployment.  ``absorb_gathered`` fans the post-gather merge to
    every host window, and checkpoint state is re-merged to the per-rank v4
    schema so a resume may repartition onto any host count.
    """

    def __init__(self, windows: Sequence[ShardedWindow]) -> None:
        if not windows:
            raise ValueError("need at least one host window")
        self.windows = list(windows)
        self.world_size = self.windows[0].world_size
        self._owner: dict[int, ShardedWindow] = {}
        for window in self.windows:
            for rank in window.host_ranks:
                if rank in self._owner:
                    raise ValueError(f"rank {rank} owned by two host windows")
                self._owner[rank] = window
        if len(self._owner) != self.world_size:
            raise ValueError(
                f"host windows cover {sorted(self._owner)} of "
                f"{self.world_size} ranks"
            )
        self.ledger = self.windows[0].ledger

    # -- ViewSource ------------------------------------------------------------
    def take(self, rank: int, k: int) -> list[Sample]:
        return self._owner[rank].take(rank, k)

    def exhausted(self, rank: int) -> bool:
        return self._owner[rank].exhausted(rank)

    def remaining(self, rank: int) -> int:
        return self._owner[rank].remaining(rank)

    def shard_state(self, rank: int) -> dict:
        return self._owner[rank].shard_state(rank)

    def absorb_gathered(self, states: Sequence[dict | None]) -> None:
        for window in self.windows:
            window.absorb_gathered(states)

    # -- merged observability ----------------------------------------------------
    @property
    def stats(self) -> WindowStats:
        """Epoch-aggregate stats across host windows.

        ``peak_resident`` sums the per-host peaks — an upper bound on the
        true global peak (hosts peak at different instants), and exactly the
        quantity the ``Σ L_r`` lookahead contract bounds.
        """
        agg = WindowStats()
        for window in self.windows:
            st = window.stats
            agg.realized += st.realized
            agg.delivered += st.delivered
            agg.refusals += st.refusals
            agg.quarantined += st.quarantined
            agg.peak_resident += st.peak_resident
        return agg

    @property
    def resident(self) -> int:
        return sum(window.resident for window in self.windows)

    @property
    def quarantined(self) -> list[dict]:
        return self.ledger.records

    # Hook fan-out: the executor assigns these exactly like on a plain window.
    @property
    def on_quarantine(self):
        return self.windows[0].on_quarantine

    @on_quarantine.setter
    def on_quarantine(self, fn) -> None:
        for window in self.windows:
            window.on_quarantine = fn

    @property
    def on_remote_quarantine(self):
        return self.windows[0].on_remote_quarantine

    @on_remote_quarantine.setter
    def on_remote_quarantine(self, fn) -> None:
        for window in self.windows:
            window.on_remote_quarantine = fn

    # -- checkpointing -----------------------------------------------------------
    def state_dict(self) -> dict:
        """Merged per-rank state, schema-identical to ``AdmissionWindow``'s.

        The checkpoint is host-count-agnostic by construction: every field is
        keyed by rank, so :meth:`load_state_dict` can split it over any other
        partition (including a single plain window).
        """
        w0 = self.windows[0]
        merged = {
            "cursors": [self._owner[r].cursors[r] for r in range(self.world_size)],
            "view_id_base": w0.view_id_base,
            "shuffle_epoch": w0.shuffle_epoch,
            "pipeline_epoch": w0.pipeline_epoch,
            "lookahead": w0.lookahead,
            "staged": [
                [
                    [s.view_id, s.identity, s.length]
                    for s in self._owner[r].staged[r]
                ]
                for r in range(self.world_size)
            ],
            "delivered_per_rank": [
                self._owner[r].delivered_per_rank[r]
                for r in range(self.world_size)
            ],
            "stats": self.stats.as_dict(),
            "max_quarantine": self.ledger.budget,
            "quarantined": [dict(q) for q in self.ledger.records],
            "remote_quarantined": sorted(
                set().union(*(w.remote_quarantined for w in self.windows))
            ),
        }
        return merged

    def load_state_dict(self, state: dict) -> None:
        from repro_torch.core.grouping import Sample as _Sample

        self.ledger.budget = state["max_quarantine"]
        self.ledger.load(state["quarantined"])
        remote = set(state.get("remote_quarantined", []))
        for i, window in enumerate(self.windows):
            window.lookahead = state["lookahead"]
            window.rank_lookahead = split_lookahead(
                window.lookahead, window.world_size
            )
            window.view_id_base = state["view_id_base"]
            window.remote_quarantined = set(remote)
            for rank in window.host_ranks:
                window.cursors[rank] = state["cursors"][rank]
                window.staged[rank] = collections.deque(
                    _Sample(view_id=v, identity=ident, length=ln)
                    for v, ident, ln in state["staged"][rank]
                )
                window.delivered_per_rank[rank] = state["delivered_per_rank"][rank]
            # Aggregate stats cannot be split back per host; attribute the
            # whole epoch-aggregate to host 0 (window_stats() re-aggregates,
            # so executor-level metrics are exact either way).
            window.stats = (
                WindowStats(**state["stats"]) if i == 0 else WindowStats()
            )
