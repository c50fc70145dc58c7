"""Online preprocessing pipeline simulator (the paper's observability point).

The paper's premise: the true training cost of a sample is realized only
after preprocessing, augmentation, chat templating, tokenization, and
multimodal visual-token expansion.  We model that causal structure explicitly:

  * a ``RawRecord`` carries only *pre-pipeline* attributes (character count,
    image resolution, turn count) — deliberately insufficient to compute the
    realized token length;
  * ``PipelinePolicy`` holds the transform policy (template id, cutoff,
    augmentation seed/strength, visual patch rate).  Any change to the policy
    changes realized lengths, which is exactly the event that invalidates
    offline oracle caches (App. I: "the cache is per-(dataset, transform
    policy, template, cutoff)") — tested in tests/test_oracles.py;
  * ``run_pipeline(record, policy, epoch)`` returns the realized length.
    Augmentation is epoch-dependent when ``policy.augmentation_strength > 0``
    (e.g. audio speed-perturb / image re-crop), the "augmentation-policy
    churn" regime of §1.

The simulator is deterministic given (record, policy, epoch) so audits and
property tests are reproducible.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class RawRecord:
    identity: int
    chars: int  # raw text size (pre-template, pre-tokenizer)
    turns: int = 1  # chat turns (template overhead multiplier)
    image_pixels: int = 0  # 0 => text-only
    audio_frames: int = 0  # 0 => not audio


@dataclasses.dataclass(frozen=True)
class PipelinePolicy:
    """Transform policy — the oracle cache key (dataset fixed separately)."""

    template: str = "chatml"
    cutoff_len: int = 16384
    chars_per_token: float = 3.6
    template_tokens_per_turn: int = 11
    visual_tokens_per_megapixel: int = 729  # Qwen-VL-style patch expansion
    augmentation_strength: float = 0.0  # 0 = deterministic lengths per epoch
    tokenizer: str = "qwen3"

    def cache_key(self, dataset: str) -> str:
        body = (
            f"{dataset}|{self.template}|{self.cutoff_len}|{self.chars_per_token}"
            f"|{self.template_tokens_per_turn}|{self.visual_tokens_per_megapixel}"
            f"|{self.augmentation_strength}|{self.tokenizer}"
        )
        return hashlib.sha1(body.encode()).hexdigest()[:16]


def _unit_hash(*parts: object) -> float:
    """Deterministic uniform(0,1) from arbitrary parts."""
    h = hashlib.sha1("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class SampleCorruptionError(RuntimeError):
    """Online realization failed for one sample (poison input, codec error).

    The admission window converts this into a quarantine entry — component
    ``X`` of the extended No-Leak partition (R, Q, B, E, X) — when a
    quarantine budget is configured (DESIGN.md §15); with the default
    strict budget of 0 it propagates like any realization error.
    """


# Chaos injection point (repro_torch.chaos): called at the top of run_pipeline with
# (record, policy, epoch); raising there simulates a poison sample whose
# corruption only manifests once the online pipeline touches it.  None = off.
_FAULT_HOOK: "Callable[[RawRecord, PipelinePolicy, int], None] | None" = None


def set_pipeline_fault_hook(hook) -> "Callable | None":
    """Install (or clear, with None) the pipeline fault hook; returns the
    previous hook so callers can restore it."""
    global _FAULT_HOOK
    previous = _FAULT_HOOK
    _FAULT_HOOK = hook
    return previous


def run_pipeline(record: RawRecord, policy: PipelinePolicy, epoch: int = 0) -> int:
    """Realize the post-pipeline tokenized length of one sample.

    Stages (all length-affecting, mirroring §1):
      1. augmentation — multiplicative jitter drawn per (identity, epoch)
         when strength > 0 (speed perturb / crop / paraphrase);
      2. chat templating — per-turn fixed token overhead;
      3. tokenization — chars / chars_per_token with a per-sample
         tokenizer-efficiency wobble (content-dependent);
      4. visual-token expansion — image pixels → patch tokens;
      5. cutoff — hard clip at ``cutoff_len`` (experiments use cutoffs above
         the realized max, so this is a guardrail, not truncation).
    """
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(record, policy, epoch)
    aug = 1.0
    if policy.augmentation_strength > 0:
        u = _unit_hash("aug", record.identity, epoch, policy.augmentation_strength)
        aug = 1.0 + policy.augmentation_strength * (2.0 * u - 1.0)
    wobble = 0.9 + 0.2 * _unit_hash("tok", record.identity, policy.tokenizer)
    text_tokens = (record.chars * aug) / (policy.chars_per_token * wobble)
    template_tokens = record.turns * policy.template_tokens_per_turn
    visual_tokens = 0.0
    if record.image_pixels > 0:
        crop = 1.0
        if policy.augmentation_strength > 0:
            u = _unit_hash("crop", record.identity, epoch)
            crop = 1.0 - 0.3 * policy.augmentation_strength * u
        visual_tokens = (
            record.image_pixels * crop / 1.0e6
        ) * policy.visual_tokens_per_megapixel
    audio_tokens = record.audio_frames / 2.0  # conv-stem downsample stub
    total = int(round(text_tokens + template_tokens + visual_tokens + audio_tokens))
    return max(1, min(total, policy.cutoff_len))


def realize_lengths(
    records: list[RawRecord], policy: PipelinePolicy, epoch: int = 0
) -> list[int]:
    """Eager full-dataset realization (the offline regime).

    The streaming path deliberately has no list-returning counterpart:
    ``AdmissionWindow`` (DESIGN.md §9.1) calls :func:`run_pipeline` one view
    at a time so peak realized-lengths in flight stays within its lookahead.
    """
    return [run_pipeline(r, policy, epoch) for r in records]


def length_cv(lengths) -> float:
    """CV = sigma / mu — the paper's heterogeneity metric (§1)."""
    n = len(lengths)
    if n == 0:
        return 0.0
    mu = sum(lengths) / n
    var = sum((l - mu) ** 2 for l in lengths) / n
    return math.sqrt(var) / mu if mu > 0 else 0.0


def short_sample_fraction(lengths, l_max: int) -> float:
    """f_s = Pr[l < L_max / 4] — short-sample mass (§4, App. K)."""
    if not lengths:
        return 0.0
    thresh = l_max / 4.0
    return sum(1 for l in lengths if l < thresh) / len(lengths)
