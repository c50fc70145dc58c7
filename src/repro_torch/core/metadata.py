"""Trainer-facing per-step metadata (paper §2.4 API contract).

The reference LLaMA-Factory integration consumes ODB step metadata for
emitted-sample accounting, token-level loss scaling, and optional
sample-quota stopping.  This is the framework-agnostic version of that
interface: one ``StepMetadata`` per aligned trainer step.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.grouping import Group


@dataclasses.dataclass(frozen=True)
class StepMetadata:
    """Metadata of one step-aligned emission across W ranks."""

    step: int
    samples_per_rank: tuple[int, ...]
    tokens_per_rank: tuple[int, ...]  # real (unpadded) token counts t_r
    padded_tokens_per_rank: tuple[int, ...]
    idle_ranks: tuple[int, ...]

    @property
    def world_size(self) -> int:
        return len(self.samples_per_rank)

    @property
    def emitted_samples(self) -> int:
        return sum(self.samples_per_rank)

    @property
    def total_tokens(self) -> int:
        return sum(self.tokens_per_rank)

    @property
    def total_padded_tokens(self) -> int:
        return sum(self.padded_tokens_per_rank)

    @property
    def padding_fraction(self) -> float:
        padded = self.total_padded_tokens
        return 0.0 if padded == 0 else 1.0 - self.total_tokens / padded


def step_metadata(step: int, batches: Sequence[Group | None]) -> StepMetadata:
    """Build metadata from one aligned step's per-rank batches (IDLE = None)."""
    samples, tokens, padded, idle = [], [], [], []
    for rank, group in enumerate(batches):
        if group is None:
            samples.append(0)
            tokens.append(0)
            padded.append(0)
            idle.append(rank)
        else:
            samples.append(group.size)
            tokens.append(group.real_tokens)
            padded.append(group.padded_tokens)
    return StepMetadata(
        step=step,
        samples_per_rank=tuple(samples),
        tokens_per_rank=tuple(tokens),
        padded_tokens_per_rank=tuple(padded),
        idle_ranks=tuple(idle),
    )


@dataclasses.dataclass
class EmitAccounting:
    """Cumulative trainer-side accounting (drives quota stop + throughput)."""

    emitted_samples: int = 0
    emitted_tokens: int = 0
    padded_tokens: int = 0
    device_tokens: int = 0  # token slots actually occupied on device (layout)
    steps: int = 0
    max_step_samples: int = 0  # S_max (Theorem 2 overshoot bound)

    def update(self, md: StepMetadata, device_tokens: int = 0) -> None:
        self.steps += 1
        self.emitted_samples += md.emitted_samples
        self.emitted_tokens += md.total_tokens
        self.padded_tokens += md.total_padded_tokens
        self.device_tokens += device_tokens
        self.max_step_samples = max(self.max_step_samples, md.emitted_samples)

    @property
    def padding_fraction(self) -> float:
        if self.padded_tokens == 0:
            return 0.0
        return 1.0 - self.emitted_tokens / self.padded_tokens

    @property
    def device_padding_fraction(self) -> float:
        """1 - real/occupied over what the chosen batch layout shipped to
        device — the measured quantity the padded-vs-packed choice moves."""
        if self.device_tokens == 0:
            return 0.0
        return 1.0 - self.emitted_tokens / self.device_tokens
