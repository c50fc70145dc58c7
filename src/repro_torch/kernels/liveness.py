"""Block-liveness tables for the pruned flash kernel.

A cheap pass over per-block segment-id ranges builds, per (batch, q-block)
row, a compacted index of live kv blocks plus a live count; the pruned kernel
walks ``kv_idx[b, qb, :kv_count[b, qb]]`` in ascending order, which is the
dense kernel's order, so the two are bit-exact.  The causal reach folds into
the liveness, so causally dead tiles prune too.  The column tables (per
(batch, kv-block): which q blocks attend into it) are for the kv-stationary
backward of the training path.  Both kernel families (K4–K6 and the MLA
kernels) build and check their tables through :func:`liveness_tables`.

Plain torch on the segments' device.  The index clamp past the live count
(repeat the last live block) is kept so the tables equal the JAX package's
integer for integer; the CUDA kernel never reads past ``kv_count``.
:func:`fetched_tile_counts` is the JAX package's host-side fetch census,
kept for parity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import _SEG_BIG, _host_segments, select_block


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


def liveness_tables(segment_ids: torch.Tensor, block_q: int, block_kv: int, causal: bool,
                    tables: LivenessTables | None = None) -> LivenessTables:
    """The tables of one kernel grid: built from ``segment_ids`` when
    ``tables`` is None, else ``tables`` checked against the grid
    (B, S/block_q, S/block_kv): shapes, int32, the segments' device,
    contiguous.  Every kernel over the tables (K4–K6 and the MLA kernels)
    takes them through here."""
    if tables is None:
        return build_liveness_tables(segment_ids, block_q=block_q, block_kv=block_kv, causal=causal)
    b, s = segment_ids.shape
    nq, nk = s // block_q, s // block_kv
    for t, shape in zip(tables, ((b, nq, nk), (b, nq), (b, nk, nq), (b, nk))):
        if (t.shape != shape or t.dtype != torch.int32 or t.device != segment_ids.device
                or not t.is_contiguous()):
            raise ValueError("liveness tables do not match the kernel grid")
    return tables


def fetched_tile_counts(
    segment_ids,
    s: int,
    block_q: int,
    block_kv: int,
    *,
    causal: bool = True,
    heads: int = 1,
    kv_heads: int = 1,
    head_dim: int = 64,
    itemsize: int = 4,
) -> dict:
    """The JAX package's kv-tile fetch census for the forward grid, dense vs
    pruned, kept rule for rule so the two packages' numbers agree.

    The rule is the Pallas pipeline's on the TPU, not the CUDA kernels':
    walking the (b, h, nq, nk) grid in row-major order, a kv tile is
    (re)fetched whenever the kv index map's result differs from the previous
    grid step's.  The dense grid maps step ik to kv block ik (every step
    fetches); the pruned grid maps through the clamped row index, so the
    dead tail of each row repeats the last live block and fetches nothing.
    Bytes count the k and v tiles (``2 · block_kv · head_dim · itemsize``
    per fetch).  The CUDA kernels load per thread block instead: K1 loads
    every tile that passes its liveness test and K4 every tile in its table,
    ``live_tile_counts(...)["segment_live"]`` tiles per head in both.  Sets
    the ``kernel_fetched_tile_fraction`` and ``kernel_fetched_kv_bytes``
    gauges (``grid=dense|pruned``).
    """
    import numpy as np

    seg = _host_segments(segment_ids)
    bsz = seg.shape[0]
    block_q = select_block(s, block_q)
    block_kv = select_block(s, block_kv)
    nq, nk = s // block_q, s // block_kv
    g = max(heads // kv_heads, 1)

    live = block_liveness(torch.from_numpy(np.ascontiguousarray(seg, np.int32)),
                          block_q, block_kv, causal=causal).numpy()
    counts = live.sum(axis=-1)  # (B, nq)

    dense_fetches = 0
    pruned_fetches = 0
    prev_dense = None
    prev_pruned = None
    for ib in range(bsz):
        for ih in range(heads):
            kvh = ih // g
            for iq in range(nq):
                row_live = np.flatnonzero(live[ib, iq])
                cnt = int(counts[ib, iq])
                last = int(row_live[-1]) if cnt else 0
                for ik in range(nk):
                    tile_d = (ib, kvh, ik)
                    if tile_d != prev_dense:
                        dense_fetches += 1
                    prev_dense = tile_d
                    kb = int(row_live[ik]) if ik < cnt else last
                    tile_p = (ib, kvh, kb)
                    if tile_p != prev_pruned:
                        pruned_fetches += 1
                    prev_pruned = tile_p

    steps = bsz * heads * nq * nk
    tile_bytes = 2 * block_kv * head_dim * itemsize  # k + v
    out = {
        "grid": [bsz, heads, nq, nk],
        "block_q": block_q,
        "block_kv": block_kv,
        "grid_steps": steps,
        "live_tiles": int(counts.sum()),
        "dense_fetches": dense_fetches,
        "pruned_fetches": pruned_fetches,
        "dense_fetched_fraction": dense_fetches / steps if steps else 0.0,
        "pruned_fetched_fraction": pruned_fetches / steps if steps else 0.0,
        "kv_tile_bytes": tile_bytes,
        "dense_fetched_bytes": dense_fetches * tile_bytes,
        "pruned_fetched_bytes": pruned_fetches * tile_bytes,
    }
    from repro_torch import obs  # deferred: keep kernel import time lean

    obs.gauge(
        "kernel_fetched_tile_fraction",
        help="fraction of forward-grid steps that DMA a fresh kv tile",
        grid="dense",
    ).set(out["dense_fetched_fraction"])
    obs.gauge("kernel_fetched_tile_fraction", grid="pruned").set(
        out["pruned_fetched_fraction"]
    )
    obs.gauge(
        "kernel_fetched_kv_bytes",
        help="kv bytes DMA'd by the forward grid per batch",
        grid="dense",
    ).set(float(out["dense_fetched_bytes"]))
    obs.gauge("kernel_fetched_kv_bytes", grid="pruned").set(
        float(out["pruned_fetched_bytes"])
    )
    return out
