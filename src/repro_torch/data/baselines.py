"""Online baselines: Standard, Sorted, Packing (paper §3.1).

All batchers share one output contract so benchmarks compare like-for-like:
``epoch_schedule(...) -> list[list[Group | None]]`` — a list of aligned
steps, each holding one Group (or IDLE None) per rank.  Padding / update
geometry then comes from ``Group`` itself (padded area = size × max_len).

  * Standard — fixed batch size, random sampling.  The per-step padded cost
    is bs × max-length-in-batch.
  * Sorted — online length-grouped fixed batch: sort within a grouping
    buffer, emit fixed-bs batches of adjacent lengths.  (The paper's Sorted
    is the online analogue of HF group_by_length with a runtime buffer.)
  * Packing — sequence packing into fixed token windows; on the card this
    is contamination-free via the segment-aware CUDA flash kernels, so it
    is a first-class backend here rather than a text-only caveat.  Packed
    "groups" report zero intra-window padding except the final partial
    window.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

from repro_torch.core.grouping import Group, Sample
from repro_torch.data.sampler import SamplerSpec, shard_views


def _per_rank_views(
    lengths: Sequence[int], world_size: int, seed: int, epoch: int
) -> list[list[Sample]]:
    spec = SamplerSpec(dataset_size=len(lengths), world_size=world_size, seed=seed)
    return shard_views(spec, epoch, lengths)


def _steps_from_rank_batches(
    rank_batches: list[list[Group]],
) -> list[list[Group | None]]:
    """Zip per-rank batch lists into aligned steps, padding tails with IDLE."""
    steps = max(len(b) for b in rank_batches)
    out: list[list[Group | None]] = []
    for i in range(steps):
        out.append([b[i] if i < len(b) else None for b in rank_batches])
    return out


def standard_schedule(
    lengths: Sequence[int],
    world_size: int,
    batch_size: int,
    *,
    seed: int = 0,
    epoch: int = 0,
) -> list[list[Group | None]]:
    """Fixed-bs random batching (DDP default).  drop_last=False semantics."""
    views = _per_rank_views(lengths, world_size, seed, epoch)
    rank_batches = []
    for rank_views in views:
        batches = [
            Group(samples=tuple(rank_views[i : i + batch_size]))
            for i in range(0, len(rank_views), batch_size)
        ]
        rank_batches.append(batches)
    return _steps_from_rank_batches(rank_batches)


def sorted_schedule(
    lengths: Sequence[int],
    world_size: int,
    batch_size: int,
    *,
    buffer_size: int = 1024,
    seed: int = 0,
    epoch: int = 0,
) -> list[list[Group | None]]:
    """Online length-grouped fixed batch: sort per buffer window, emit bs."""
    views = _per_rank_views(lengths, world_size, seed, epoch)
    rank_batches = []
    for rank_views in views:
        batches: list[Group] = []
        for start in range(0, len(rank_views), buffer_size):
            window = sorted(
                rank_views[start : start + buffer_size], key=lambda s: s.length
            )
            for i in range(0, len(window), batch_size):
                chunk = window[i : i + batch_size]
                if chunk:
                    batches.append(Group(samples=tuple(chunk)))
        rank_batches.append(batches)
    return _steps_from_rank_batches(rank_batches)


def packing_schedule(
    lengths: Sequence[int],
    world_size: int,
    window_tokens: int,
    *,
    seed: int = 0,
    epoch: int = 0,
) -> list[list[Group | None]]:
    """Greedy sequential packing into fixed token windows (first-fit order).

    Each emitted Group holds the samples packed into one window; its padded
    area is the window size (``window_tokens``) — i.e. only the final partial
    fill of each window is waste.  Downstream, the segment-aware attention
    kernel keeps windows contamination-free.  Samples longer than the window
    get a singleton window (paper keeps cutoff above max length).
    """
    views = _per_rank_views(lengths, world_size, seed, epoch)
    rank_batches = []
    for rank_views in views:
        batches: list[Group] = []
        current: list[Sample] = []
        used = 0
        for s in rank_views:
            if current and used + s.length > window_tokens:
                batches.append(Group(samples=tuple(current)))
                current, used = [], 0
            current.append(s)
            used += s.length
        if current:
            batches.append(Group(samples=tuple(current)))
        rank_batches.append(batches)
    return _steps_from_rank_batches(rank_batches)


def packed_area(group: Group, window_tokens: int) -> int:
    """Compute cost of a packed window (fixed window area)."""
    return window_tokens * math.ceil(group.real_tokens / window_tokens)


def sweep_batch_sizes(
    candidates: Sequence[int] = (1, 2, 4, 8, 16)
) -> tuple[int, ...]:
    """Paper's Standard/Sorted sweep grid (§3.1)."""
    return tuple(candidates)
