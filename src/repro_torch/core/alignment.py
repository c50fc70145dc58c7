"""Max-Based Bidirectional Group Alignment (paper Alg. 1, Eq. 3, App. A).

Given per-rank candidate group lists with differing counts, compute the
global alignment target over *active* ranks

    T_grp = max( min( max_{r in A} G_r,  C_min+,  S_min+ ),  1 )        (Eq. 3)

where ``C_min+`` / ``S_min+`` are the minimum *positive* output-slot capacity
and buffered-sample count over active ranks (excluding zero values prevents an
empty rank from collapsing the target, App. A), then adjust each active rank:

  * Split (upward, G_r < T_grp): scanning groups in reverse order, find the
    first group with >= 2 samples and extract its *last* sample as a new
    singleton; repeat until G_r == T_grp.
  * Overflow (downward, G_r > T_grp): keep the T_grp largest groups; return
    samples of removed groups to the buffer for recirculation (no discard).

Both operations conserve the sample multiset (Lemma 1 feeds on this).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.grouping import Group, Sample


@dataclasses.dataclass(frozen=True)
class RankAlignmentState:
    """Per-rank inputs to the alignment round (contents of the all_gather)."""

    groups: tuple[Group, ...]
    capacity: int  # output-slot capacity C_r (0 => no free slots this round)
    buffered: int  # buffered-sample count S_r (samples inside groups + spares)

    @property
    def group_count(self) -> int:
        return len(self.groups)


def alignment_target(states: Sequence[RankAlignmentState]) -> int:
    """Compute ``T_grp`` (Eq. 3) over active ranks (G_r > 0).

    Returns 0 when no rank is active (nothing to align this round).
    """
    active = [s for s in states if s.group_count > 0]
    if not active:
        return 0
    g_max = max(s.group_count for s in active)
    pos_caps = [s.capacity for s in active if s.capacity > 0]
    pos_bufs = [s.buffered for s in active if s.buffered > 0]
    c_min = min(pos_caps) if pos_caps else g_max
    s_min = min(pos_bufs) if pos_bufs else g_max
    return max(min(g_max, c_min, s_min), 1)


@dataclasses.dataclass(frozen=True)
class AlignmentResult:
    """Aligned groups plus recirculated overflow samples for one rank."""

    groups: tuple[Group, ...]
    recirculated: tuple[Sample, ...]
    splits: int
    overflowed_groups: int


def split_upward(groups: list[Group], target: int) -> tuple[list[Group], int]:
    """Split until ``len(groups) == target`` (Alg. 1 lines 3-6).

    Scans from the last group backward for the first group with >= 2 samples
    and extracts its last sample as a new singleton group.  If no splittable
    group remains the rank stays below target (the protocol layer then pads
    with IDLE outputs; the theorems only require G_r <= target emission with
    step alignment via idle sentinels).
    """
    groups = list(groups)
    splits = 0
    while len(groups) < target:
        donor_idx = -1
        for i in range(len(groups) - 1, -1, -1):
            if groups[i].size >= 2:
                donor_idx = i
                break
        if donor_idx < 0:
            break  # nothing splittable: protocol pads with IDLE sentinels
        donor = groups[donor_idx]
        remaining, extracted = donor.samples[:-1], donor.samples[-1]
        groups[donor_idx] = Group(samples=remaining)
        groups.append(Group(samples=(extracted,)))
        splits += 1
    return groups, splits


def overflow_downward(
    groups: list[Group], target: int
) -> tuple[list[Group], list[Sample]]:
    """Keep the ``target`` largest groups; recirculate the rest (Alg. 1 line 8).

    "Largest" is by sample count (ties broken by token count then original
    order, deterministically).  Returned extras go back to the rank's buffer —
    overflow recirculation ensures no samples are permanently discarded.
    """
    if len(groups) <= target:
        return list(groups), []
    order = sorted(
        range(len(groups)),
        key=lambda i: (-groups[i].size, -groups[i].real_tokens, i),
    )
    keep = sorted(order[:target])  # preserve original emission order
    drop = sorted(order[target:])
    kept = [groups[i] for i in keep]
    extras: list[Sample] = []
    for i in drop:
        extras.extend(groups[i].samples)
    return kept, extras


def align_rank(state: RankAlignmentState, target: int) -> AlignmentResult:
    """Apply bidirectional adjustment for one active rank (Alg. 1 body)."""
    if state.group_count == 0 or target <= 0:
        return AlignmentResult(
            groups=state.groups, recirculated=(), splits=0, overflowed_groups=0
        )
    groups = list(state.groups)
    splits = 0
    recirculated: list[Sample] = []
    overflowed = 0
    if len(groups) < target:
        groups, splits = split_upward(groups, target)
    elif len(groups) > target:
        before = len(groups)
        groups, recirculated = overflow_downward(groups, target)
        overflowed = before - len(groups)
    return AlignmentResult(
        groups=tuple(groups),
        recirculated=tuple(recirculated),
        splits=splits,
        overflowed_groups=overflowed,
    )


def align_all(
    states: Sequence[RankAlignmentState],
) -> tuple[int, list[AlignmentResult]]:
    """One full alignment round over all ranks: target + per-rank adjustment."""
    target = alignment_target(states)
    return target, [align_rank(s, target) for s in states]
