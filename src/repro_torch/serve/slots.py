"""Slot-based KV-cache manager.

The decode step runs against one fixed-shape cache of ``num_slots`` rows
× ``max_len`` positions; a *slot* is one row.  Admission allocates a slot,
completion/eviction frees it, and the next scheduler tick refills it — the
step shape never changes (one decode shape per engine, counted by the
step census in ``launch/steps.py``).

Stale rows are safe by masking, not by zeroing: a freed slot's K/V stays in
device memory, but every read is bounded by the per-slot frontier
(``lengths``) that resets on re-allocation, and every re-prefill overwrites
positions ``[0, prompt_len)`` — so reuse needs no cache clears on the hot
path.
"""

from __future__ import annotations

import collections

import numpy as np

from repro_torch.serve.requests import Request


class SlotManager:
    """Free-list of KV-cache rows plus the host-side per-slot frontier."""

    def __init__(self, num_slots: int, max_len: int) -> None:
        if num_slots <= 0:
            raise ValueError(f"num_slots must be positive, got {num_slots}")
        self.num_slots = num_slots
        self.max_len = max_len
        self._free: collections.deque[int] = collections.deque(range(num_slots))
        self._requests: list[Request | None] = [None] * num_slots
        # Device-step inputs, mutated host-side between ticks:
        self.lengths = np.zeros((num_slots,), np.int32)  # cached tokens per slot
        self.last_token = np.zeros((num_slots,), np.int32)  # pending decode input
        # (slot, rid) in allocation order — the reuse audit trail.
        self.assignments: list[tuple[int, int]] = []

    # -- occupancy -------------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    def active(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._requests) if r is not None]

    def projected_in_flight(self) -> int:
        """Σ projected KV footprints of resident requests (≤ l_max invariant)."""
        return sum(r.projected_tokens for _, r in self.active())

    # -- lifecycle -------------------------------------------------------------
    def alloc(self, request: Request) -> int:
        if not self._free:
            raise RuntimeError("no free slot")
        if request.projected_tokens > self.max_len:
            raise ValueError(
                f"request {request.rid} projects {request.projected_tokens} "
                f"tokens > slot capacity {self.max_len}"
            )
        slot = self._free.popleft()
        self._requests[slot] = request
        request.slot = slot
        self.lengths[slot] = 0
        self.last_token[slot] = 0
        self.assignments.append((slot, request.rid))
        return slot

    def release(self, slot: int) -> Request:
        request = self._requests[slot]
        if request is None:
            raise ValueError(f"slot {slot} is already free")
        self._requests[slot] = None
        self._free.append(slot)
        return request
