"""Host-side collective channel for the alignment protocol (the part of the
JAX package's ``core/comm.py`` that ``core/protocol.py`` needs).

``LoopbackCollective`` is in-process and round-synchronous: every simulated
rank deposits its payload for round ``k`` and the gathered list goes back to
every rank.  It enforces and audits the **uniform all_gather invariant**
(Lemma 3): every rank must call exactly once per round, otherwise the channel
raises, so a deadlock of the real system surfaces as a hard error in tests.
The multi-process transport and the fault-tolerant wrapper of the JAX
package are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Sequence


class ProtocolDesyncError(RuntimeError):
    """A rank broke the uniform-call invariant (would deadlock on hardware)."""


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
