"""Block-liveness tables for the pruned flash kernel.

A cheap pass over per-block segment-id ranges builds, per (batch, q-block)
row, a compacted index of live kv blocks plus a live count; the pruned kernel
walks ``kv_idx[b, qb, :kv_count[b, qb]]`` in ascending order, which is the
dense kernel's order, so the two are bit-exact.  The causal reach folds into
the liveness, so causally dead tiles prune too.  The column tables (per
(batch, kv-block): which q blocks attend into it) are for the kv-stationary
backward of the training path.

Plain torch on the segments' device.  The index clamp past the live count
(repeat the last live block) is kept so the tables equal the JAX package's
integer for integer; the CUDA kernel never reads past ``kv_count``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import _SEG_BIG


class LivenessTables(NamedTuple):
    """Compacted live-block indices for one (segment_ids, block_q, block_kv).

    ``kv_idx[b, qb, t]`` is the t-th live kv block of q-block ``qb``
    (ascending), clamped to the last live block for ``t >= kv_count[b, qb]``;
    ``q_idx`` / ``q_count`` are the transposed column tables.  Rows with no
    live block carry count 0 and index 0.
    """

    kv_idx: torch.Tensor  # (B, nq, nk) int32
    kv_count: torch.Tensor  # (B, nq) int32
    q_idx: torch.Tensor  # (B, nk, nq) int32
    q_count: torch.Tensor  # (B, nk) int32


def _range_bounds(segment_ids: torch.Tensor, block: int):
    """Per-block (lo, hi) over positive segment ids; lo = _SEG_BIG when the
    block is all padding.  Valid because ids are nondecreasing over the real
    prefix of a packed row."""
    b, s = segment_ids.shape
    blocks = segment_ids.reshape(b, s // block, block)
    lo = torch.where(blocks > 0, blocks, _SEG_BIG).amin(dim=-1)
    hi = blocks.amax(dim=-1)
    return lo, hi


def block_liveness(
    segment_ids: torch.Tensor, block_q: int, block_kv: int, *, causal: bool = True
) -> torch.Tensor:
    """(B, nq, nk) bool — the kernel's liveness rule, vectorized: segment
    ranges overlap (ids 0 excluded) AND (causal ⇒ the q block can reach the
    kv block)."""
    _, s = segment_ids.shape
    nq, nk = s // block_q, s // block_kv
    q_lo, q_hi = _range_bounds(segment_ids, block_q)
    k_lo, k_hi = _range_bounds(segment_ids, block_kv)
    live = (
        (q_hi[:, :, None] > 0)
        & (k_hi[:, None, :] > 0)
        & (q_hi[:, :, None] >= k_lo[:, None, :])
        & (k_hi[:, None, :] >= q_lo[:, :, None])
    )
    if causal:
        dev = segment_ids.device
        qb = torch.arange(nq, dtype=torch.int32, device=dev)
        kb = torch.arange(nk, dtype=torch.int32, device=dev)
        reach = (qb[:, None] * block_q + block_q - 1) >= kb[None, :] * block_kv
        live &= reach[None]
    return live


def compact_index(live: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact a (..., n) liveness mask into (idx, count): live positions in
    ascending order for ``t < count``, the last live position repeated
    beyond it (0 for a row with none)."""
    n = live.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=live.device)
    key = torch.where(live, ar, n + ar)
    order = torch.argsort(key, dim=-1, stable=True).to(torch.int32)
    count = live.sum(dim=-1, dtype=torch.int32)
    step = ar.expand(live.shape)
    clamped = torch.minimum(step, (count[..., None] - 1).clamp(min=0))
    idx = torch.gather(order, -1, clamped.long()).to(torch.int32)
    return idx.contiguous(), count.contiguous()


def build_liveness_tables(
    segment_ids: torch.Tensor,
    *,
    block_q: int,
    block_kv: int,
    causal: bool = True,
) -> LivenessTables:
    """Row and column tables for one packed batch; the block pair must be
    resolved (``select_block`` applied)."""
    _, s = segment_ids.shape
    if s % block_q or s % block_kv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) do not divide S={s}")
    live = block_liveness(segment_ids, block_q, block_kv, causal=causal)
    kv_idx, kv_count = compact_index(live)
    q_idx, q_count = compact_index(live.transpose(1, 2))
    return LivenessTables(kv_idx, kv_count, q_idx, q_count)
