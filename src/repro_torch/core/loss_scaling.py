"""Loss scaling under heterogeneous per-rank batches (paper §2.3, App. B, N).

ODB's per-rank batches differ in token counts ``t_r``, so naive DDP averaging
``(1/W) Σ_r L̄_r`` is a biased estimate of the per-token reference loss

    L* = (1/T_tok) Σ_{r,i,k} ℓ_{r,i,k},      T_tok = Σ_r t_r.           (Eq. 4)

Prescaling each rank's loss by ``W · w_r`` makes DDP's post-averaging output
equal ``Σ_r w_r L̄_r``; the unique weight that recovers ``L*`` exactly is the
token-level weight ``w_r = t_r / T_tok`` (Eq. 2).  Sample-level weighting
``w_r = n_r / N`` matches only when ``t_r / n_r`` is constant across ranks.

Three modes (App. N):
  1. ``sample``        — w_r = n_r / n_total.
  2. ``approx_token``  — token-level with post-alignment tokens *estimated*
                         from the pre-alignment mean: t_adj ≈ n_adj · t̄_r.
  3. ``exact_token``   — token-level with true post-alignment counts
                         (re-broadcast by the deterministic second gather).

``exact_token`` also annihilates IDLE batches exactly (t_r = 0 ⇒ w_r = 0),
which is what lets the data-parallel step schedule include IDLE slots
without biasing the loss (DESIGN.md §2).

Numerics note: the prescale is applied in the algebraically-stable form
``W · ℓ_sum_r / T_tok`` (identical to ``W · w_r · L̄_r`` in exact arithmetic,
but avoiding the ``t_r`` divide-then-multiply round trip), so the
post-averaging output is *bitwise* equal to computing ``Σ_r ℓ_sum_r / T_tok``
with the same summation order — the Eq. 2 bit-exactness contract we test.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

MODES = ("sample", "approx_token", "exact_token")


@dataclasses.dataclass(frozen=True)
class RankLossStats:
    """Per-rank loss statistics for one aligned trainer step."""

    loss_sum: float  # Σ_{i,k} ℓ_{r,i,k} over valid tokens
    tokens: int  # t_r (post-alignment true count)
    samples: int  # n_r
    tokens_pre_alignment: int | None = None  # for approx mode
    samples_pre_alignment: int | None = None

    @property
    def mean_loss(self) -> float:
        return 0.0 if self.tokens == 0 else self.loss_sum / self.tokens


def token_weights(tokens: Sequence[int]) -> np.ndarray:
    """w_r = t_r / T_tok (Eq. 2); all-zero step maps to zero weights."""
    t = np.asarray(tokens, dtype=np.float64)
    total = t.sum()
    if total == 0:
        return np.zeros_like(t)
    return t / total


def sample_weights(samples: Sequence[int]) -> np.ndarray:
    n = np.asarray(samples, dtype=np.float64)
    total = n.sum()
    if total == 0:
        return np.zeros_like(n)
    return n / total


def approx_token_counts(stats: Sequence[RankLossStats]) -> list[float]:
    """App. B approximate mode: t_adj ≈ n_adj · t̄_r with t̄_r from the
    *pre-alignment* piggybacked counts (no second gather)."""
    out = []
    for s in stats:
        n_pre = s.samples_pre_alignment
        t_pre = s.tokens_pre_alignment
        if not n_pre or t_pre is None:
            out.append(float(s.tokens))
        else:
            out.append(s.samples * (t_pre / n_pre))
    return out


def ddp_scaled_loss(stats: Sequence[RankLossStats], mode: str) -> float:
    """Simulate DDP post-averaging output of the prescaled per-rank losses.

    Returns ``mean_r( W · w_r · L̄_r )`` computed in the stable form.  With
    ``mode='exact_token'`` this equals the per-token reference bit-precisely.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    w_count = len(stats)
    if w_count == 0:
        return 0.0
    if mode == "sample":
        weights = sample_weights([s.samples for s in stats])
        scaled = [
            w_count * weights[r] * stats[r].mean_loss for r in range(w_count)
        ]
        return float(np.sum(scaled) / w_count)
    if mode == "approx_token":
        t_est = approx_token_counts(stats)
        total = float(np.sum(t_est))
        if total == 0:
            return 0.0
        scaled = [
            w_count * (t_est[r] / total) * stats[r].mean_loss
            for r in range(w_count)
        ]
        return float(np.sum(scaled) / w_count)
    # exact_token — stable form: W * ℓ_sum_r / T_tok, then mean over ranks.
    total_tokens = float(np.sum([s.tokens for s in stats], dtype=np.float64))
    if total_tokens == 0:
        return 0.0
    scaled = [w_count * s.loss_sum / total_tokens for s in stats]
    return float(np.sum(scaled) / w_count)


def reference_per_token_loss(stats: Sequence[RankLossStats]) -> float:
    """L* = Σ ℓ_sum_r / Σ t_r — the single-pass per-token mean (Eq. 4)."""
    total_tokens = float(np.sum([s.tokens for s in stats], dtype=np.float64))
    if total_tokens == 0:
        return 0.0
    return float(np.sum([s.loss_sum for s in stats]) / total_tokens)


def prescale_factor(
    local_tokens,  # tensor or number: t_r
    global_tokens,  # T_tok (from all_reduce or the second gather)
    world_size: int,
    mode: str = "exact_token",
    local_samples=None,
    global_samples=None,
):
    """Factor applied to the local *mean* loss before the DP mean-reduce.

    Pure arithmetic, so it takes tensors as well as numbers.
    ``mean_r(factor_r · L̄_r)`` then equals the mode's target.  For
    exact_token: factor = W · t_r / T_tok.
    """
    if mode == "exact_token" or mode == "approx_token":
        return world_size * local_tokens / global_tokens
    if mode == "sample":
        if local_samples is None or global_samples is None:
            raise ValueError("sample mode needs sample counts")
        return world_size * local_samples / global_samples
    raise ValueError(f"unknown mode {mode!r}")


def prescaled_loss(
    loss_sum,  # Σ ℓ over this rank's valid tokens
    tokens,  # t_r
    global_tokens,  # T_tok (all tensors)
    world_size: int,
    mode: str = "exact_token",
    local_samples=None,
    global_samples=None,
):
    """This rank's prescaled loss, whose mean over the ranks is the mode's
    target.  The token modes use the stable form ``W · ℓ_sum_r / T_tok`` of
    the module docstring, so the mean over ranks rounds as
    ``Σ_r ℓ_sum_r / T_tok`` does; sample mode scales the local mean by
    :func:`prescale_factor`."""
    if mode in ("exact_token", "approx_token"):
        return world_size * loss_sum / global_tokens
    return loss_sum / tokens.clamp(min=1.0) * prescale_factor(
        tokens, global_tokens, world_size, mode,
        local_samples=local_samples, global_samples=global_samples,
    )
