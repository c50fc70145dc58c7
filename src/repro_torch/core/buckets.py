"""Packed-stream bucket grids (copy of the JAX package's ``PackedBucketSpec``).

Padding a packed prefill stream up to a small grid of (rows, row capacity)
shapes bounds the number of distinct step shapes while keeping padding low.
"""

from __future__ import annotations

import bisect
import dataclasses


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class PackedBucketSpec:
    """Packed-stream bucket grids: row capacity (tokens) × row count."""

    min_tokens: int = 1024
    max_tokens: int = 1 << 20
    align: int = 128
    max_rows: int = 4096

    def grid(self) -> list[int]:
        out = []
        t = self.min_tokens
        while t < self.max_tokens:
            out.append(t)
            mid = _round_up(t * 3 // 2, self.align)
            if t < mid < min(t * 2, self.max_tokens):
                out.append(mid)  # 1.5x midpoints: tail waste <= 1/3 of a step
            t *= 2
        out.append(self.max_tokens)
        return sorted(set(out))

    def bucket_tokens(self, total: int) -> int:
        grid = self.grid()
        idx = bisect.bisect_left(grid, total)
        if idx >= len(grid):
            raise ValueError(f"{total} tokens exceed packed cutoff")
        return grid[idx]

    def row_grid(self) -> list[int]:
        out = []
        r = 1
        while r < self.max_rows:
            out.append(r)
            mid = r * 3 // 2
            if r < mid < min(r * 2, self.max_rows):
                out.append(mid)  # 1.5x midpoints: tail waste <= 1/3 of a step
            r *= 2
        out.append(self.max_rows)
        return sorted(set(out))

    def bucket_rows(self, rows: int) -> int:
        grid = self.row_grid()
        idx = bisect.bisect_left(grid, rows)
        if idx >= len(grid):
            raise ValueError(f"{rows} rows exceed packed max_rows {self.max_rows}")
        return grid[idx]
