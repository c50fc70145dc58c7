"""Packed row planning (the ``plan_rows`` part of the JAX package's
``PackedLayout``): first-fit-decreasing packing of a group into bounded
``(rows, row_capacity)`` segment streams."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.buckets import PackedBucketSpec
from repro_torch.core.grouping import Group


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """First-fit-decreasing packing into bounded ``(rows, row_capacity)``."""

    spec: PackedBucketSpec = dataclasses.field(default_factory=PackedBucketSpec)

    @staticmethod
    def _first_fit(order: Sequence, cap: int) -> list[list]:
        rows: list[list] = []
        used: list[int] = []
        for sample in order:
            for r, u in enumerate(used):
                if u + sample.length <= cap:
                    rows[r].append(sample)
                    used[r] = u + sample.length
                    break
            else:
                rows.append([sample])
                used.append(sample.length)
        return rows

    @staticmethod
    def _order(group: Group) -> list:
        """Deterministic first-fit-decreasing order (ties break on view_id)."""
        return sorted(group.samples, key=lambda s: (-s.length, s.view_id))

    def plan_rows(self, group: Group) -> tuple[int, list[list]]:
        """Pick (row_capacity, first-fit-decreasing row assignment).

        Every grid capacity that fits the longest sample AND keeps the row
        count within ``max_rows`` is a candidate; the one minimizing the
        bucketed device area wins (ties → the narrowest, which also gives
        the smallest kernel block shapes).
        """
        order = self._order(group)
        best: tuple[int, list[list]] | None = None
        best_area = None
        for cap in self.spec.grid():
            if cap < group.max_length:
                continue
            rows = self._first_fit(order, cap)
            if len(rows) > self.spec.max_rows:
                continue  # narrow cap needs too many rows; wider may fit
            area = self.spec.bucket_rows(len(rows)) * cap
            if best_area is None or area < best_area:
                best, best_area = (cap, rows), area
        if best is None:
            raise ValueError(
                f"group (max_length {group.max_length}, {group.size} samples)"
                f" does not fit the packed grid (max_tokens "
                f"{self.spec.max_tokens}, max_rows {self.spec.max_rows})"
            )
        return best
