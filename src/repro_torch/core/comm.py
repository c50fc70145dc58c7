"""Host-side collective channel for the alignment protocol (the JAX
package's ``core/comm.py`` without its multi-process transport).

``LoopbackCollective`` is in-process and round-synchronous: every simulated
rank deposits its payload for round ``k`` and the gathered list goes back to
every rank.  It enforces and audits the **uniform all_gather invariant**
(Lemma 3): every rank must call exactly once per round, otherwise the channel
raises, so a deadlock of the real system surfaces as a hard error in tests.

``ResilientCollective`` wraps a transport with the fault-tolerance policy of
DESIGN.md §15: a per-round delivery deadline, bounded retry with exponential
backoff + deterministic jitter, and a typed, *recoverable* failure
(:class:`RankTimeoutError`) that is distinct from the unrecoverable-by-design
:class:`ProtocolDesyncError`.  The wrapper memoizes per-rank payloads so a
retried round never re-runs the protocol's side-effecting payload closures —
only the transport attempt repeats.

``TorchProcessCollective`` is the multi-process transport (one process per
rank or host): an ``all_gather`` of a flat int64 vector (the wire codec
below) over a ``torch.distributed`` process group, audited per tag like the
loopback.  ``ResilientCollective.all_gather`` wraps it under the deadline.
Unlike the JAX package's watchdog thread, which retries a wedged gather, the
port issues the gather asynchronously and waits for it up to the deadline; a
real miss raises :class:`RankTimeoutError` without a retry, because an
abandoned ``torch.distributed`` collective stays queued on its group and a
retry would pair with the wrong collective of a peer.  Injected (simulated)
faults are retried as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import zlib
from typing import Any, Callable, Sequence

from repro_torch import obs


class ProtocolDesyncError(RuntimeError):
    """A rank broke the uniform-call invariant (would deadlock on hardware)."""


class RankTimeoutError(RuntimeError):
    """A rank missed the per-round delivery deadline after bounded retries.

    Recoverable by construction (unlike :class:`ProtocolDesyncError`, which
    is a protocol *bug*): the failed gather never reached the audited
    transport, so every rank still holds its pre-gather state and an
    executor checkpoint taken afterwards resumes the identical round
    (``StreamExecutor`` converts this into a resumable ``EpochAborted``).

    ``failed_ranks`` carries EVERY rank that failed the final attempt (a
    correlated fault — a downed host — takes out several at once), with
    per-rank reasons in ``failures``; ``rank`` keeps the first for
    backward-compatible callers.
    """

    def __init__(
        self,
        message: str,
        *,
        rank: int | None = None,
        round_index: int | None = None,
        attempts: int = 0,
        failed_ranks: Sequence[int] | None = None,
        failures: Sequence[tuple[int, str]] | None = None,
    ) -> None:
        super().__init__(message)
        self.rank = rank
        self.round_index = round_index
        self.attempts = attempts
        if failed_ranks is None:
            failed_ranks = [] if rank is None else [rank]
        self.failed_ranks = list(failed_ranks)
        self.failures = [tuple(f) for f in (failures or [])]


@dataclasses.dataclass
class ChannelStats:
    rounds: int = 0
    bytes_exchanged: int = 0
    secondary_rounds: int = 0  # optional second gather (exact loss scaling)

    def record(self, payloads: Sequence[Any], secondary: bool) -> None:
        self.rounds += 1
        if secondary:
            self.secondary_rounds += 1
        try:
            self.bytes_exchanged += sum(
                len(json.dumps(p, default=str).encode()) for p in payloads
            )
        except TypeError:
            pass


class Collective:
    """Abstract round-synchronous all_gather over ``world_size`` ranks."""

    def __init__(self, world_size: int) -> None:
        if world_size <= 0:
            raise ValueError("world_size must be positive")
        self.world_size = world_size
        self.stats = ChannelStats()

    def all_gather(self, rank: int, payload: Any, *, tag: str = "primary") -> list[Any]:
        raise NotImplementedError


class LoopbackCollective(Collective):
    """Round-synchronous in-process collective driven by a protocol engine.

    The engine collects one payload per rank per round and then delivers the
    gathered list back; per-rank call counts are audited so a rank that calls
    out of lockstep (the distributed-deadlock failure mode) raises
    ``ProtocolDesyncError`` instead of hanging.
    """

    def __init__(self, world_size: int) -> None:
        super().__init__(world_size)
        self._pending: dict[str, dict[int, Any]] = {}
        self._calls_per_rank = [0] * world_size

    # -- engine-driven API ---------------------------------------------------
    def gather_round(
        self,
        payload_fn: Callable[[int], Any],
        *,
        tag: str = "primary",
    ) -> list[Any]:
        """Run one synchronous round: collect payloads from every rank.

        ``payload_fn(rank)`` plays the role of rank ``r`` reaching its
        ``all_gather`` call site.  Every rank *must* produce a payload — a
        rank that cannot (raises) is a protocol bug, mirrored as an exception.
        """
        payloads = [payload_fn(rank) for rank in range(self.world_size)]
        for rank in range(self.world_size):
            self._calls_per_rank[rank] += 1
        counts = set(self._calls_per_rank)
        if len(counts) != 1:
            raise ProtocolDesyncError(
                f"uniform all_gather invariant violated: per-rank call counts "
                f"{self._calls_per_rank}"
            )
        self.stats.record(payloads, secondary=(tag != "primary"))
        return payloads

    def all_gather(self, rank: int, payload: Any, *, tag: str = "primary") -> list[Any]:
        raise NotImplementedError(
            "LoopbackCollective is engine-driven; use gather_round()"
        )


class TorchProcessCollective(Collective):
    """Rank-driven transport over the default ``torch.distributed`` process group.

    One payload per process: an ``all_gather`` of the payload as a flat int64
    vector (:func:`encode_round_payload`), on CPU tensors under gloo and on
    the current CUDA device under NCCL.  Every payload travels behind a
    two-word header (a CRC of the tag, the rank's call count for the tag), so
    a peer that calls out of lockstep raises :class:`ProtocolDesyncError` on
    every rank instead of silently mis-slicing; the per-tag audit of the JAX
    package's ``JaxProcessCollective`` is kept (no tag may run ahead of the
    primary rounds).  Payloads must have one length on every rank, as the
    wire codec's do.
    """

    def __init__(self, world_size: int | None = None) -> None:
        import torch.distributed as dist

        actual = dist.get_world_size()
        if world_size is not None and world_size != actual:
            raise ValueError(f"world_size {world_size} != the process group's {actual}")
        super().__init__(actual)
        self.rank = dist.get_rank()
        self.calls_per_tag: dict[str, int] = {}
        nccl = dist.get_backend() == "nccl"
        self._device = "cuda" if nccl else "cpu"

    def all_gather_async(self, rank: int, payload: Any, *, tag: str = "primary") -> "PendingGather":
        """Issue the gather and return without waiting for it."""
        import numpy as np
        import torch
        import torch.distributed as dist

        if rank != self.rank:
            raise ValueError(f"rank {rank} gathers on the process of rank {self.rank}")
        count = self.calls_per_tag.get(tag, 0) + 1
        vec = np.concatenate([[zlib.crc32(tag.encode()), count],
                              np.asarray(payload, dtype=np.int64).reshape(-1)])
        sent = torch.from_numpy(vec).to(self._device)
        out = [torch.empty_like(sent) for _ in range(self.world_size)]
        work = dist.all_gather(out, sent, async_op=True)
        return PendingGather(self, work, out, tag, count)

    def all_gather(self, rank: int, payload: Any, *, tag: str = "primary") -> list[Any]:
        return self.all_gather_async(rank, payload, tag=tag).wait()

    def _deliver(self, out: list, tag: str, count: int) -> list:
        gathered = [t.cpu().numpy() for t in out]
        headers = [(int(g[0]), int(g[1])) for g in gathered]
        if len(set(headers)) != 1:
            raise ProtocolDesyncError(
                f"uniform all_gather invariant violated: rank {self.rank} called tag "
                f"{tag!r} #{count}, the ranks' (tag crc, call) headers are {headers}"
            )
        self.calls_per_tag[tag] = count
        primary = self.calls_per_tag.get("primary", 0)
        for t, n in self.calls_per_tag.items():
            if t != "primary" and n > primary:
                raise ProtocolDesyncError(
                    f"uniform all_gather invariant violated: tag {t!r} "
                    f"called {n}x against {primary} primary rounds"
                )
        payloads = [g[2:] for g in gathered]
        self.stats.record([p.tolist() for p in payloads], secondary=(tag != "primary"))
        return payloads


class PendingGather:
    """An issued :meth:`TorchProcessCollective.all_gather_async`."""

    def __init__(self, collective: TorchProcessCollective, work, out: list, tag: str,
                 count: int) -> None:
        self.collective, self.work, self.out, self.tag, self.count = (
            collective, work, out, tag, count)

    def wait(self, timeout_s: float | None = None) -> list | None:
        """The gathered payloads, or None when ``timeout_s`` passes first
        (the collective then stays queued on its group)."""
        if timeout_s is not None:
            end = time.monotonic() + timeout_s
            while not self.work.is_completed():
                if time.monotonic() >= end:
                    return None
                time.sleep(1e-3)
        self.work.wait()  # surfaces the transport's error, orders NCCL's stream
        return self.collective._deliver(self.out, self.tag, self.count)


# -- int64 wire codec for the round payload (deployment parity) ---------------
#
# ``LoopbackCollective`` moves the payload dict by reference; the rank-driven
# transport (``TorchProcessCollective``) moves a flat int64 vector per process.  The layout extends the
# paper's [idx_budget, n_groups, sizes, tokens] schema with the §16 window
# summary so a real multi-host deployment exchanges admission state in the
# same single unconditional gather:
#
#   [ idx_budget, n_groups, n,
#     sizes[0..cap), tokens[0..cap),            # zero-padded to group cap
#     has_window, host, cursor, staged, delivered, resident,
#     qids[0..qcap) ]                           # -1-padded charged |X| ids

_WINDOW_SLOTS = 6  # has_window flag + the five summary fields


def round_payload_length(group_capacity: int, quarantine_capacity: int = 0) -> int:
    return 3 + 2 * group_capacity + _WINDOW_SLOTS + quarantine_capacity


def encode_round_payload(
    payload: dict, *, group_capacity: int, quarantine_capacity: int = 0
):
    """Flatten one rank's round payload dict to the fixed int64 wire layout."""
    import numpy as np

    sizes = list(payload.get("sizes", ()))
    tokens = list(payload.get("tokens", ()))
    if len(sizes) > group_capacity or len(tokens) > group_capacity:
        raise ValueError(
            f"{max(len(sizes), len(tokens))} groups exceed wire capacity "
            f"{group_capacity}"
        )
    vec = np.zeros(
        round_payload_length(group_capacity, quarantine_capacity), np.int64
    )
    vec[0] = payload["idx_budget"]
    vec[1] = payload["n_groups"]
    vec[2] = len(sizes)
    vec[3 : 3 + len(sizes)] = sizes
    base = 3 + group_capacity
    vec[base : base + len(tokens)] = tokens
    wbase = 3 + 2 * group_capacity
    window = payload.get("window")
    qids: list[int] = []
    if window is not None:
        vec[wbase] = 1
        vec[wbase + 1] = window.get("host", 0)
        vec[wbase + 2] = window.get("cursor", 0)
        vec[wbase + 3] = window.get("staged", 0)
        vec[wbase + 4] = window.get("delivered", 0)
        vec[wbase + 5] = window.get("resident", 0)
        qids = list(window.get("quarantined_ids", ()))
        if len(qids) > quarantine_capacity:
            raise ValueError(
                f"{len(qids)} quarantined ids exceed wire capacity "
                f"{quarantine_capacity}"
            )
    qbase = wbase + _WINDOW_SLOTS
    vec[qbase:] = -1
    vec[qbase : qbase + len(qids)] = qids
    return vec


def decode_round_payload(
    vec, *, group_capacity: int, quarantine_capacity: int = 0
) -> dict:
    """Invert :func:`encode_round_payload` back to the payload dict."""
    vec = [int(v) for v in vec]
    expected = round_payload_length(group_capacity, quarantine_capacity)
    if len(vec) != expected:
        raise ValueError(f"wire payload length {len(vec)} != {expected}")
    n = vec[2]
    out: dict[str, Any] = {
        "idx_budget": vec[0],
        "n_groups": vec[1],
        "sizes": vec[3 : 3 + n],
        "tokens": vec[3 + group_capacity : 3 + group_capacity + n],
    }
    wbase = 3 + 2 * group_capacity
    if vec[wbase]:
        qbase = wbase + _WINDOW_SLOTS
        out["window"] = {
            "host": vec[wbase + 1],
            "cursor": vec[wbase + 2],
            "staged": vec[wbase + 3],
            "delivered": vec[wbase + 4],
            "resident": vec[wbase + 5],
            "quarantined_ids": [q for q in vec[qbase:] if q >= 0],
        }
    return out


def _unit_jitter(*parts: object) -> float:
    """Deterministic uniform(0,1) from arbitrary parts (no wall-clock RNG)."""
    h = hashlib.sha1("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class ResilientCollective(Collective):
    """Deadline + bounded-retry wrapper over another collective (§15).

    Policy per gather: attempt delivery; a rank that misses ``deadline_s``
    (or whose payload a fault injector drops) fails the attempt.  Up to
    ``max_retries`` retries follow, spaced by exponential backoff with
    deterministic jitter (``base · 2^(attempt-1) · U[0.5, 1.5)``, capped at
    ``backoff_cap_s``; the jitter is a pure hash of (seed, round, attempt)
    so fault runs replay bit-exactly).  When retries are exhausted the
    gather raises :class:`RankTimeoutError` — the caller's rank state is
    untouched because nothing reached the inner transport.

    Wrapping ``LoopbackCollective`` (engine-driven ``gather_round``): the
    per-rank payload closures run **once**, on the first attempt; retries
    replay the memoized payloads, so protocol side effects (candidate-group
    collection) never double-run and the inner collective's uniform-call
    audit still sees exactly one call per rank per logical round.  Injected
    faults are *simulated* against the deadline — chaos runs spend no wall
    clock on the faults themselves, only on the (configurable) backoff.

    Wrapping ``TorchProcessCollective`` (rank-driven ``all_gather``): each
    attempt issues the gather asynchronously and waits up to the deadline.
    A miss raises :class:`RankTimeoutError` at once, with no retry: the
    abandoned collective stays queued on the process group (see the module
    docstring).  An injected fault is decided before the gather is issued,
    so it is retried as in the JAX package.

    ``injector`` is the chaos hook (the JAX package's ``repro.chaos.inject``
    implements it; the port has no chaos module yet): called as
    ``on_gather(round_index, attempt, rank, tag)`` and returns ``None``
    (clean), ``"drop"`` (payload lost), or a float (simulated delivery
    latency in seconds — a fault only if it exceeds the deadline).
    """

    def __init__(
        self,
        inner: Collective,
        *,
        deadline_s: float = 1.0,
        max_retries: int = 2,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        injector: Any = None,
        sleep_fn: Callable[[float], None] = time.sleep,
        seed: int = 0,
    ) -> None:
        super().__init__(inner.world_size)
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.inner = inner
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.injector = injector
        self.sleep_fn = sleep_fn
        self.seed = seed
        self.stats = inner.stats  # one ChannelStats: the wrapper adds no rounds
        self.retries = 0  # failed attempts that were retried
        self.recovered = 0  # gathers that succeeded after >= 1 retry
        self._round_counter = 0  # wrapper-local gather ordinal (primary tag)
        self._m_retries = obs.counter(
            "odb_fault_retries_total",
            help="gather attempts retried after a deadline miss or drop",
        )
        self._m_recovered = obs.counter(
            "odb_fault_recovered_total",
            help="gathers that succeeded after at least one retry",
        )

    # -- retry policy ----------------------------------------------------------
    def _backoff_delay(self, round_index: int, attempt: int) -> float:
        base = min(
            self.backoff_cap_s, self.backoff_base_s * (2 ** max(attempt - 1, 0))
        )
        jitter = 0.5 + _unit_jitter("backoff", self.seed, round_index, attempt)
        return base * jitter

    def _failed_ranks(
        self, round_index: int, attempt: int, tag: str
    ) -> list[tuple[int, str]]:
        """Ranks whose delivery fails this attempt (injector-simulated)."""
        if self.injector is None:
            return []
        failed: list[tuple[int, str]] = []
        for rank in range(self.world_size):
            fault = self.injector.on_gather(round_index, attempt, rank, tag)
            if fault is None:
                continue
            if fault == "drop":
                failed.append((rank, "payload dropped"))
            else:
                delay = float(fault)
                if delay > self.deadline_s:
                    failed.append(
                        (rank, f"delivery {delay:.3f}s > deadline {self.deadline_s:.3f}s")
                    )
        return failed

    def _retry_loop(self, round_index: int, tag: str, attempt_fn):
        """Run ``attempt_fn(attempt) -> (ok, failures)`` under the policy."""
        attempt = 0
        failures: list[tuple[int, str]] = []
        while True:
            ok, failures = attempt_fn(attempt)
            if ok:
                if attempt > 0:
                    self.recovered += 1
                    self._m_recovered.inc()
                return
            self.retries += 1
            self._m_retries.inc()
            attempt += 1
            if attempt > self.max_retries:
                # Report EVERY failed rank, not just the first: the straggler
                # census, stream_abort.json and the operator's restart
                # decision all need the full casualty list of the round.
                ranks = [r for r, _ in failures]
                detail = (
                    "; ".join(f"rank {r}: {why}" for r, why in failures)
                    or "timeout"
                )
                raise RankTimeoutError(
                    f"round {round_index} ({tag}): ranks "
                    f"{ranks if ranks else '?'} failed delivery "
                    f"after {attempt} attempts ({detail})",
                    rank=ranks[0] if ranks else None,
                    round_index=round_index,
                    attempts=attempt,
                    failed_ranks=ranks,
                    failures=failures,
                )
            self.sleep_fn(self._backoff_delay(round_index, attempt))

    # -- engine-driven path (Loopback) -------------------------------------------
    def gather_round(
        self, payload_fn: Callable[[int], Any], *, tag: str = "primary"
    ) -> list[Any]:
        round_index = self._round_counter
        payloads: list[Any] | None = None

        def attempt(n: int):
            nonlocal payloads
            if payloads is None:
                # First attempt only: protocol payload closures may have side
                # effects (candidate collection); retries reuse the memo.
                payloads = [payload_fn(rank) for rank in range(self.world_size)]
            return (not (failed := self._failed_ranks(round_index, n, tag)), failed)

        self._retry_loop(round_index, tag, attempt)
        if tag == "primary":
            self._round_counter += 1
        assert payloads is not None
        return self.inner.gather_round(lambda r: payloads[r], tag=tag)

    # -- rank-driven path (TorchProcess) ------------------------------------------
    def all_gather(self, rank: int, payload: Any, *, tag: str = "primary") -> list[Any]:
        round_index = self._round_counter
        box: dict[str, Any] = {}

        def attempt(n: int):
            failed = [f for f in self._failed_ranks(round_index, n, tag) if f[0] == rank]
            if failed:
                return False, failed
            out = self.inner.all_gather_async(rank, payload, tag=tag).wait(self.deadline_s)
            if out is None:
                why = f"no delivery within {self.deadline_s:.3f}s"
                raise RankTimeoutError(
                    f"round {round_index} ({tag}): rank {rank} saw {why} (not retried: the "
                    f"abandoned collective stays queued on its process group)",
                    rank=rank, round_index=round_index, attempts=n + 1,
                    failed_ranks=[rank], failures=[(rank, why)],
                )
            box["out"] = out
            return True, []

        self._retry_loop(round_index, tag, attempt)
        if tag == "primary":
            self._round_counter += 1
        return box["out"]
