"""Deterministic seeded fault plans (DESIGN.md §15.5).

Every chaos decision — which round's gather is delayed, which rank's payload
drops, which identities are poison, at which submission a worker dies, how
much of a checkpoint file survives — is a pure hash of ``(seed, site)``.
There is no wall-clock RNG anywhere in the subsystem, so a fault run replays
bit-exactly: the same seed produces the same fault schedule, the same retry
trajectory, and the same recovered stream, which is what lets the harness
assert bit-exactness *through* injected failures rather than merely
"it didn't crash".
"""

from __future__ import annotations

import dataclasses
import hashlib

FAULT_KINDS = (
    "gather_delay",  # transient: deadline-missing delivery, recovers on retry
    "gather_drop",  # hard: payload lost on every attempt -> EpochAborted
    "slow_rank",  # persistent sub-deadline straggler (no faults, no retries)
    "poison_sample",  # realization raises -> quarantine component X
    "worker_kill",  # SIGKILL a realization worker mid-claim
    "ckpt_truncate",  # torn latest train checkpoint -> keep-k fallback
)


def unit_hash(*parts: object) -> float:
    """Deterministic uniform(0,1) from arbitrary parts (no wall-clock RNG)."""
    h = hashlib.sha1("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """One seed's worth of fault-site decisions, queried per injection point."""

    seed: int
    world_size: int

    # -- collective faults -----------------------------------------------------
    def delay(
        self, round_index: int, rank: int, *, rate: float, max_delay_s: float
    ) -> float | None:
        """Simulated delivery latency for (round, rank), or None (clean).

        The draw and the magnitude hash different sites so changing the rate
        never re-rolls the magnitudes of faults that still fire.
        """
        if unit_hash("delay", self.seed, round_index, rank) >= rate:
            return None
        return max_delay_s * unit_hash("delay-mag", self.seed, round_index, rank)

    def drop(self, round_index: int, rank: int, *, rate: float) -> bool:
        """True when (round, rank)'s payload is scheduled to drop."""
        return unit_hash("drop", self.seed, round_index, rank) < rate

    # -- data faults -------------------------------------------------------------
    def poison_identities(self, n: int, *, count: int) -> frozenset[int]:
        """``count`` distinct identities in [0, n) whose realization fails."""
        count = min(count, n)
        ranked = sorted(range(n), key=lambda i: unit_hash("poison", self.seed, i))
        return frozenset(ranked[:count])

    # -- process / file faults -----------------------------------------------------
    def kill_seq(self, total: int) -> int:
        """Submission ordinal at which a realization worker is SIGKILLed."""
        if total <= 0:
            return 0
        return int(unit_hash("kill", self.seed) * total)

    def truncate_fraction(self) -> float:
        """Surviving prefix fraction for a torn checkpoint file, in [0.3, 0.9)."""
        return 0.3 + 0.6 * unit_hash("truncate", self.seed)
