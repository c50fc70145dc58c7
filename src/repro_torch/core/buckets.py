"""TPU shape-bucketing for dynamic groups (hardware adaptation; DESIGN.md §2).

XLA compiles one program per input shape.  ODB emits variable-size groups
``(n, max_len)``; padding each group up to a small geometric grid of bucket
shapes bounds the number of compiled programs while keeping padding low —
and ODB's token-budget rule concentrates groups near ``L_max`` tokens, which
makes the grid unusually cheap (measured in benchmarks/lmax_ablation).

Two grids:
  * lengths:  powers of two (optionally with a 1.5× midpoint) in
              [min_len, cutoff_len], always hardware-aligned to multiples of
              ``align`` (default 128, the MXU lane width);
  * counts:   {1, 2, 4, 8} then multiples of 8 (sublane-friendly).

``PackedBucketSpec`` buckets packed token streams (segment-id-tagged rows for
the Pallas segment-aware attention kernel): a row-capacity grid over token
counts plus a small row-count grid, so padding decays to the tail bucket while
kernel block shapes stay bounded.  The layout engine (``core/layout.py``)
builds on both specs; ``pad_group``/``pack_group`` remain the low-level
single-group emitters (serving path, kernels tests).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.grouping import Group


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def sample_token_ids(sample, *, vocab_size: int = 32000, token_fn=None) -> np.ndarray:
    """Token ids for one sample — the single synthesis point for every layout.

    ``token_fn(sample) -> np.ndarray`` extracts ids from the payload; the
    default synthesizes deterministic ids from the view id bounded by
    ``vocab_size`` (benchmarks and tests where only lengths matter).  Both
    dense and packed emitters call this, so the two layouts see bit-identical
    token streams for the same sample.
    """
    if token_fn is not None:
        return np.asarray(token_fn(sample), dtype=np.int32)[: sample.length]
    rng = np.random.default_rng(sample.view_id)
    return rng.integers(1, vocab_size, size=sample.length, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Geometric (count, length) bucket grid."""

    min_len: int = 128
    max_len: int = 32768  # cutoff_len analogue: above the longest realized
    max_count: int = 4096
    align: int = 128
    use_midpoints: bool = True  # add 1.5x length midpoints (denser grid)

    def length_grid(self) -> list[int]:
        grid: list[int] = []
        step = self.min_len
        while step < self.max_len:
            grid.append(step)
            if self.use_midpoints:
                mid = _round_up(step * 3 // 2, self.align)
                if step < mid < min(step * 2, self.max_len):
                    grid.append(mid)
            step *= 2
        grid.append(self.max_len)
        return sorted(set(_round_up(g, self.align) for g in grid))

    def count_grid(self) -> list[int]:
        grid = [1, 2, 4]
        c = 8
        while c <= self.max_count:
            grid.append(c)
            c += 8 if c < 32 else (16 if c < 128 else c // 2)
        if grid[-1] < self.max_count:
            grid.append(self.max_count)
        return grid

    def bucket_length(self, length: int) -> int:
        grid = self.length_grid()
        idx = bisect.bisect_left(grid, length)
        if idx >= len(grid):
            raise ValueError(
                f"length {length} exceeds bucket cutoff {self.max_len}"
            )
        return grid[idx]

    def bucket_count(self, count: int) -> int:
        grid = self.count_grid()
        idx = bisect.bisect_left(grid, count)
        if idx >= len(grid):
            raise ValueError(f"count {count} exceeds max_count {self.max_count}")
        return grid[idx]

    def bucket_shape(self, count: int, length: int) -> tuple[int, int]:
        return self.bucket_count(count), self.bucket_length(length)

    def num_shapes(self) -> int:
        return len(self.count_grid()) * len(self.length_grid())


@dataclasses.dataclass(frozen=True)
class PaddedBatch:
    """A group padded to its bucket shape, ready for the jitted step."""

    tokens: np.ndarray  # (n_bucket, len_bucket) int32
    loss_mask: np.ndarray  # (n_bucket, len_bucket) float32 — 1 on valid targets
    lengths: np.ndarray  # (n_bucket,) int32 — real per-row lengths (0 = pad row)
    real_samples: int
    real_tokens: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.tokens.shape  # type: ignore[return-value]

    @property
    def padding_fraction(self) -> float:
        area = self.tokens.shape[0] * self.tokens.shape[1]
        return 1.0 - self.real_tokens / area if area else 0.0


def pad_group(
    group: Group,
    spec: BucketSpec,
    *,
    pad_id: int = 0,
    token_fn=None,
    vocab_size: int = 32000,
) -> PaddedBatch:
    """Right-pad a group's samples into the bucketed dense batch.

    ``token_fn(sample) -> np.ndarray`` extracts token ids from the payload;
    default synthesizes deterministic ids from the view id bounded by
    ``vocab_size`` (for benchmarks and tests where only lengths matter).
    """
    n_b, l_b = spec.bucket_shape(group.size, group.max_length)
    tokens = np.full((n_b, l_b), pad_id, dtype=np.int32)
    mask = np.zeros((n_b, l_b), dtype=np.float32)
    lengths = np.zeros((n_b,), dtype=np.int32)
    for i, sample in enumerate(group.samples):
        ids = sample_token_ids(sample, vocab_size=vocab_size, token_fn=token_fn)
        tokens[i, : sample.length] = ids
        mask[i, : sample.length] = 1.0
        lengths[i] = sample.length
    return PaddedBatch(
        tokens=tokens,
        loss_mask=mask,
        lengths=lengths,
        real_samples=group.size,
        real_tokens=group.real_tokens,
    )


def idle_batch(shape: tuple[int, int], pad_id: int = 0) -> PaddedBatch:
    """IDLE_DATA sentinel as a zero-token batch — annihilated by Eq. 2."""
    n, l = shape
    return PaddedBatch(
        tokens=np.full((n, l), pad_id, dtype=np.int32),
        loss_mask=np.zeros((n, l), dtype=np.float32),
        lengths=np.zeros((n,), dtype=np.int32),
        real_samples=0,
        real_tokens=0,
    )


# -----------------------------------------------------------------------------
# Beyond-paper: packed-segment emission (merges ODB with contamination-free
# packing; the Pallas segment-aware attention kernel consumes this layout).
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedBucketSpec:
    """Packed-stream bucket grids: row capacity (tokens) × row count.

    ``bucket_tokens`` buckets a token count onto the geometric
    ``[min_tokens, max_tokens]`` grid (a whole single-row stream, or — via
    the layout engine — one row's capacity, which is what keeps Pallas kernel
    block shapes bounded).  ``bucket_rows`` buckets the number of packed rows
    onto a small power-of-two grid so the compiled-shape count stays the
    product of two short grids.
    """

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


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    tokens: np.ndarray  # (1, T_bucket) int32
    segment_ids: np.ndarray  # (1, T_bucket) int32 — 0 = padding, 1..n = sample
    positions: np.ndarray  # (1, T_bucket) int32 — within-segment positions
    loss_mask: np.ndarray  # (1, T_bucket) float32
    real_samples: int
    real_tokens: int

    @property
    def padding_fraction(self) -> float:
        area = self.tokens.shape[1]
        return 1.0 - self.real_tokens / area if area else 0.0


def pack_group(
    group: Group,
    spec: PackedBucketSpec,
    *,
    pad_id: int = 0,
    token_fn=None,
    vocab_size: int = 32000,
) -> PackedBatch:
    """Concatenate a group into one packed row with segment ids/positions."""
    total = spec.bucket_tokens(group.real_tokens)
    tokens = np.full((1, total), pad_id, dtype=np.int32)
    seg = np.zeros((1, total), dtype=np.int32)
    pos = np.zeros((1, total), dtype=np.int32)
    mask = np.zeros((1, total), dtype=np.float32)
    cursor = 0
    for i, sample in enumerate(group.samples, start=1):
        ids = sample_token_ids(sample, vocab_size=vocab_size, token_fn=token_fn)
        end = cursor + sample.length
        tokens[0, cursor:end] = ids
        seg[0, cursor:end] = i
        pos[0, cursor:end] = np.arange(sample.length, dtype=np.int32)
        mask[0, cursor:end] = 1.0
        cursor = end
    return PackedBatch(
        tokens=tokens,
        segment_ids=seg,
        positions=pos,
        loss_mask=mask,
        real_samples=group.size,
        real_tokens=group.real_tokens,
    )


def bucket_padding_stats(
    groups: Sequence[Group], spec: BucketSpec
) -> dict[str, float]:
    """Aggregate device-side padding (bucket area vs real tokens)."""
    real = 0
    area = 0
    shapes: set[tuple[int, int]] = set()
    for g in groups:
        n_b, l_b = spec.bucket_shape(g.size, g.max_length)
        shapes.add((n_b, l_b))
        real += g.real_tokens
        area += n_b * l_b
    return {
        "groups": float(len(groups)),
        "real_tokens": float(real),
        "bucket_tokens": float(area),
        "bucket_padding_fraction": 1.0 - real / area if area else 0.0,
        "distinct_shapes": float(len(shapes)),
    }
