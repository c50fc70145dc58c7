"""Offline oracle baselines: GMT / BMT / HFG + the scalar length cache.

Paper §3.1 / App. I / App. J.  These are favorable comparators: they use a
one-time scalar cache of post-pipeline ``len(input_ids)`` for *batch
construction only* (training still runs the online pipeline); cache
construction cost is excluded from their throughput, and the cache is
invalidated by any (dataset, transform policy, template, cutoff) change.

  * **GMT-oracle** — fairseq-style *global* max-token batching: ascending
    length sort + greedy packing against a max-token budget, feasibility on
    the padded token area ``max_{i∈b} l_i · |b| ≤ budget`` with singleton
    overflows allowed (zero truncation, full coverage).
  * **BMT-oracle** — *bucketed* max-token: epoch-seeded shuffle,
    sample-count buckets, within-bucket length sort, greedy packing, then
    batch shuffle.
  * **HFG-oracle** — HuggingFace ``group_by_length``-style randomized fixed
    batch: random permutation → megabatches → within-megabatch sort by cached
    length → fixed-bs batches.

All are **rank-replicated**: every rank computes the same global batch list,
the list is padded to a multiple of W by wrap-around repetition of the
leading batches (the offline analogue of ODB's padding), and batches are
assigned to ranks by striding — identical step count on every rank by
construction.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Sequence

from repro_torch.core.grouping import Group, Sample
from repro_torch.data.datasets import DatasetSpec
from repro_torch.data.pipeline import PipelinePolicy, realize_lengths


class StaleCacheError(RuntimeError):
    """The scalar cache was built under a different transform policy."""


@dataclasses.dataclass
class LengthCache:
    """One-time scalar cache of post-pipeline len(input_ids) (App. I)."""

    dataset: str
    key: str
    lengths: list[int]
    build_seconds: float

    @classmethod
    def build(
        cls, spec: DatasetSpec, policy: PipelinePolicy | None = None, seed: int = 0
    ) -> "LengthCache":
        policy = policy or spec.policy
        t0 = time.perf_counter()
        lengths = realize_lengths(spec.records(seed), policy, epoch=0)
        return cls(
            dataset=spec.name,
            key=policy.cache_key(spec.name),
            lengths=lengths,
            build_seconds=time.perf_counter() - t0,
        )

    def validate(self, spec: DatasetSpec, policy: PipelinePolicy) -> None:
        """Raise if the policy changed since the cache was built (churn)."""
        if policy.cache_key(spec.name) != self.key:
            raise StaleCacheError(
                f"length cache for {self.dataset!r} was built under a different "
                f"(transform, template, cutoff) policy — rebuild required"
            )


# ---------------------------------------------------------------------------
# Batch-list construction (global, rank-replicated).
# ---------------------------------------------------------------------------


def _greedy_max_token_batches(
    order: list[int], lengths: Sequence[int], budget: int
) -> list[list[int]]:
    """Greedy packing with padded-area feasibility max_l * |b| <= budget.

    Singleton overflows allowed: a sample longer than the budget still forms
    its own batch (zero truncation, full-epoch coverage).
    """
    batches: list[list[int]] = []
    current: list[int] = []
    cur_max = 0
    for idx in order:
        l = lengths[idx]
        new_max = max(cur_max, l)
        if current and new_max * (len(current) + 1) > budget:
            batches.append(current)
            current, cur_max = [], 0
            new_max = l
        current.append(idx)
        cur_max = new_max
    if current:
        batches.append(current)
    return batches


def _pad_and_stride(
    batches: list[list[int]], world_size: int
) -> list[list[list[int]]]:
    """Pad batch list to a multiple of W by wrap-around; stride-assign.

    Returns ``steps[step][rank] -> list of identity indices``.
    """
    if not batches:
        return []
    pad = (-len(batches)) % world_size
    padded = batches + batches[:pad]
    steps = []
    for start in range(0, len(padded), world_size):
        steps.append(padded[start : start + world_size])
    return steps


def _to_group_steps(
    steps: list[list[list[int]]], lengths: Sequence[int]
) -> list[list[Group | None]]:
    out: list[list[Group | None]] = []
    view = 0
    for step in steps:
        row: list[Group | None] = []
        for batch in step:
            samples = []
            for ident in batch:
                samples.append(
                    Sample(view_id=view, identity=ident, length=lengths[ident])
                )
                view += 1
            row.append(Group(samples=tuple(samples)) if samples else None)
        out.append(row)
    return out


def gmt_schedule(
    cache: LengthCache,
    world_size: int,
    max_tokens_budget: int,
) -> list[list[Group | None]]:
    """Global max-token oracle: ascending sort + greedy packing."""
    lengths = cache.lengths
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    batches = _greedy_max_token_batches(order, lengths, max_tokens_budget)
    return _to_group_steps(_pad_and_stride(batches, world_size), lengths)


def bmt_schedule(
    cache: LengthCache,
    world_size: int,
    max_tokens_budget: int,
    *,
    bucket_samples: int = 8192,
    seed: int = 0,
    epoch: int = 0,
) -> list[list[Group | None]]:
    """Bucketed max-token oracle: shuffle → buckets → sort → pack → shuffle."""
    lengths = cache.lengths
    rng = random.Random((seed, epoch).__hash__() & 0x7FFFFFFF)
    order = list(range(len(lengths)))
    rng.shuffle(order)
    batches: list[list[int]] = []
    for start in range(0, len(order), bucket_samples):
        bucket = sorted(
            order[start : start + bucket_samples], key=lambda i: lengths[i]
        )
        batches.extend(_greedy_max_token_batches(bucket, lengths, max_tokens_budget))
    rng.shuffle(batches)
    return _to_group_steps(_pad_and_stride(batches, world_size), lengths)


def hfg_schedule(
    cache: LengthCache,
    world_size: int,
    batch_size: int,
    *,
    megabatch_factor: int = 50,
    seed: int = 0,
    epoch: int = 0,
) -> list[list[Group | None]]:
    """HF group_by_length-style randomized fixed-batch oracle (App. J)."""
    lengths = cache.lengths
    rng = random.Random((seed, epoch, "hfg").__hash__() & 0x7FFFFFFF)
    order = list(range(len(lengths)))
    rng.shuffle(order)
    mega = batch_size * megabatch_factor
    reordered: list[int] = []
    for start in range(0, len(order), mega):
        chunk = sorted(order[start : start + mega], key=lambda i: -lengths[i])
        reordered.extend(chunk)
    batches = [
        reordered[i : i + batch_size] for i in range(0, len(reordered), batch_size)
    ]
    return _to_group_steps(_pad_and_stride(batches, world_size), lengths)
