"""DistributedSampler(drop_last=False) semantics (paper App. C.1).

Produces a per-rank sampler-view sequence of size ``ceil(N/W)`` after padding
the global shuffled index list to ``M = W * ceil(N/W)`` views and
stride-sharding it across ranks.  The ``P = M - N`` deterministic tail-padding
views cyclically re-use boundary identities so per-rank counts are equal —
the surplus the App. C.6 identity audit checks against
(``W - N mod W`` when ``N % W != 0``).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

from repro_torch.core.grouping import Sample


# Logical-iteration addressing shared by the eager scheduler (odb_schedule)
# and the streaming executor.  Bit-exact eager/stream equivalence — and the
# validity of existing stream checkpoints — depends on both paths using
# these, never inline literals.
ITERATION_VIEW_ID_STRIDE = 10**9


def iteration_shuffle_epoch(epoch: int, iteration: int) -> int:
    """Shuffle-epoch for logical iteration ``iteration`` of epoch ``epoch``."""
    return epoch * 1000 + iteration


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    dataset_size: int  # N identities
    world_size: int  # W
    seed: int = 0
    shuffle: bool = True

    @property
    def per_rank_quota(self) -> int:
        return math.ceil(self.dataset_size / self.world_size)

    @property
    def total_views(self) -> int:  # M
        return self.world_size * self.per_rank_quota

    @property
    def padding_views(self) -> int:  # P = M - N
        return self.total_views - self.dataset_size


def global_view_order(spec: SamplerSpec, epoch: int) -> list[int]:
    """Shuffled identity list padded to M by cyclically re-using boundary
    identities (covers the W > N degenerate case too)."""
    ids = list(range(spec.dataset_size))
    if spec.shuffle:
        random.Random((spec.seed, epoch).__hash__() & 0x7FFFFFFF).shuffle(ids)
    pad = spec.total_views - len(ids)
    cyc = (ids * (pad // len(ids) + 1))[:pad] if pad else []
    return ids + cyc


def shard_views(
    spec: SamplerSpec,
    epoch: int,
    lengths: Sequence[int],
    *,
    view_id_base: int = 0,
) -> list[list[Sample]]:
    """Stride-shard the padded view list into per-rank Sample sequences.

    ``lengths[identity]`` is the realized post-pipeline length (supplied by
    the pipeline; the sampler itself never observes lengths — that is the
    paper's observability point).  ``view_id_base`` disambiguates views across
    chained logical iterations.
    """
    order = global_view_order(spec, epoch)
    out: list[list[Sample]] = [[] for _ in range(spec.world_size)]
    for pos, identity in enumerate(order):
        rank = pos % spec.world_size
        out[rank].append(
            Sample(
                view_id=view_id_base + pos,
                identity=identity,
                length=int(lengths[identity]),
            )
        )
    quotas = {len(v) for v in out}
    assert quotas == {spec.per_rank_quota}, quotas
    return out
