"""Dynamic batch sizing and greedy length grouping (paper §2.2, App. D).

ODB keeps the per-batch token count roughly constant via a user-specified
token budget ``L_max``.  For a realized post-pipeline sample length ``l`` the
target local group size is

    B(l) = max(floor(L_max / l), 1)                         (Eq. 1)

so that ``B(l) * l ~= L_max``.

Grouping algorithm (threshold carry-over, §2.2): buffered samples are sorted
ascending by length and iterated *from longest to shortest* with a running
group-size threshold ``t`` (initially 1).  Each sample is appended to the
current group; when the group size reaches ``t`` the group is finalized and
``t <- B(l)`` for the last-added (shortest) sample.  Successive groups
naturally hold more samples since shorter ``l`` yields larger ``B(l)``, so
per-group token counts converge to ``L_max`` (App. D worked example).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Sample:
    """A sampler view after the online pipeline has realized its length.

    Attributes:
      view_id:  unique id of the *sampler view* (distinct for padding views).
      identity: dataset identity index in ``[0, N)`` — several views may map
                to one identity because ``DistributedSampler(drop_last=False)``
                pads the view multiset to ``W * ceil(N / W)`` (App. C.1).
      length:   realized post-pipeline token length (`len(input_ids)` after
                preprocessing, augmentation, templating, tokenization and
                visual-token expansion).
      payload:  opaque per-sample data carried through to the collate_fn.
    """

    view_id: int
    identity: int
    length: int
    payload: object = None

    def __post_init__(self) -> None:
        if self.length <= 0:
            raise ValueError(f"sample length must be positive, got {self.length}")


@dataclasses.dataclass(frozen=True)
class Group:
    """A finalized variable-size batch of samples (one optimizer micro-group)."""

    samples: tuple[Sample, ...]

    def __post_init__(self) -> None:
        if not self.samples:
            raise ValueError("empty group")

    @property
    def size(self) -> int:
        return len(self.samples)

    @property
    def max_length(self) -> int:
        return max(s.length for s in self.samples)

    @property
    def real_tokens(self) -> int:
        return sum(s.length for s in self.samples)

    @property
    def padded_tokens(self) -> int:
        """Token area after right-padding every sample to the group max."""
        return self.size * self.max_length

    @property
    def padding_fraction(self) -> float:
        padded = self.padded_tokens
        return 0.0 if padded == 0 else 1.0 - self.real_tokens / padded

    def lengths(self) -> tuple[int, ...]:
        return tuple(s.length for s in self.samples)


def target_group_size(length: int, l_max: int) -> int:
    """``B(l) = max(floor(L_max / l), 1)`` — Eq. 1 (clamped memory rule)."""
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    if l_max <= 0:
        raise ValueError(f"L_max must be positive, got {l_max}")
    return max(l_max // length, 1)


def greedy_group(
    samples: Sequence[Sample],
    l_max: int,
    *,
    size_rule: Callable[[int, int], int] = target_group_size,
) -> list[Group]:
    """Threshold-carry greedy grouping (§2.2; worked example App. D).

    Sort ascending, iterate longest → shortest with running threshold ``t``
    (init 1).  Append each sample to the current group; when the group size
    reaches ``t``, finalize and set ``t <- B(l_last_added)``.  A trailing
    partial group (size < t at exhaustion) is finalized as-is so no sample is
    ever dropped (conservation feeds Lemma 1).

    Returns groups in finalization order (longest-sample group first, like the
    paper's App. D trace: G1=[800], G2=[500], G3=[100, 200]).
    """
    if l_max <= 0:
        raise ValueError(f"L_max must be positive, got {l_max}")
    ordered = sorted(samples, key=lambda s: s.length)  # ascending
    groups: list[Group] = []
    current: list[Sample] = []
    threshold = 1
    for sample in reversed(ordered):  # longest -> shortest
        current.append(sample)
        if len(current) >= threshold:
            groups.append(Group(samples=tuple(current)))
            current = []
            threshold = size_rule(sample.length, l_max)
    if current:
        groups.append(Group(samples=tuple(current)))
    return groups


def regroup(samples: Iterable[Sample], l_max: int) -> list[Group]:
    """Re-run grouping over recirculated + fresh samples (overflow reuse)."""
    return greedy_group(list(samples), l_max)


def padding_stats(groups: Sequence[Group]) -> dict[str, float]:
    """Cumulative padding statistics over a set of groups.

    ``pad%`` follows the paper's definition (App. I, Table 13):
    ``1 - sum(L_real) / sum(L_compute)`` where L_compute pads each sample to
    its group max.
    """
    real = sum(g.real_tokens for g in groups)
    padded = sum(g.padded_tokens for g in groups)
    return {
        "groups": float(len(groups)),
        "samples": float(sum(g.size for g in groups)),
        "real_tokens": float(real),
        "padded_tokens": float(padded),
        "padding_fraction": 0.0 if padded == 0 else 1.0 - real / padded,
        "mean_group_tokens": float(padded) / len(groups) if groups else 0.0,
    }
