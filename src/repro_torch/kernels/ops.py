"""Public flash-attention entry: resolves the block pair and the kernel once.

``grid`` ∈ {dense, pruned, auto} picks between the dense-loop kernels and the
pruned kernels that load only live tiles.  ``auto`` resolves to pruned
exactly when segment ids are present and the tensors lie on a CUDA device;
an explicit ``pruned`` is honored wherever segments exist, and degrades to
dense without them (there is nothing to build liveness from).

:func:`flash_attention` is a ``torch.autograd.Function`` (the counterpart of
the JAX package's ``custom_vjp``): the forward runs K1 or K4 and saves
``(q, k, v, segment_ids, out, lse)`` with the liveness tables; the backward
runs K2+K3 or K5+K6 with the forward's block pair, grid and tables, so the
three passes provably consume one resolution.  On CPU tensors both
directions take the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    resolve_blocks,
    segment_flash_attention,
    segment_flash_attention_bwd,
    segment_flash_attention_bwd_pruned,
    segment_flash_attention_pruned,
)
from repro_torch.kernels.liveness import LivenessTables, build_liveness_tables

GRID_MODES = ("dense", "pruned", "auto")


def resolve_grid(grid: str | None, segment_ids) -> str:
    """Resolve an ``attn_grid`` request to a concrete kernel variant."""
    if grid is None:
        grid = "auto"
    if grid not in GRID_MODES:
        raise ValueError(f"grid must be one of {GRID_MODES}, got {grid!r}")
    if segment_ids is None:
        return "dense"
    if grid == "auto":
        return "pruned" if segment_ids.device.type == "cuda" else "dense"
    return grid


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, block_q, block_kv, grid):
        kw = dict(causal=causal, block_q=block_q, block_kv=block_kv, return_lse=True)
        tables = ()  # the CPU path takes the plain version, which needs none
        if grid == "pruned":
            if q.device.type == "cuda":
                tables = build_liveness_tables(
                    segment_ids, block_q=block_q, block_kv=block_kv, causal=causal
                )
            out, lse = segment_flash_attention_pruned(
                q, k, v, segment_ids, tables=tables or None, **kw
            )
        else:
            out, lse = segment_flash_attention(q, k, v, segment_ids, **kw)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse, *tables)
        ctx.config = (causal, block_q, block_kv, grid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, out, lse, *tables = ctx.saved_tensors
        causal, block_q, block_kv, grid = ctx.config
        kw = dict(causal=causal, block_q=block_q, block_kv=block_kv)
        do = do.contiguous()
        if grid == "pruned":
            dq, dk, dv = segment_flash_attention_bwd_pruned(
                q, k, v, segment_ids, out, lse, do,
                tables=LivenessTables(*tables) if tables else None, **kw,
            )
        else:
            dq, dk, dv = segment_flash_attention_bwd(q, k, v, segment_ids, out, lse, do, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q, k, v, segment_ids=None, causal=True, block_q=128, block_kv=128,
    grid="auto",
):
    """Segment-masked attention of (B, S, H, D) q over (B, S, KV, D) k/v,
    differentiable in q, k and v."""
    s = q.shape[1]
    block_q, block_kv = resolve_blocks(s, block_q, block_kv)
    mode = resolve_grid(grid, segment_ids)
    return _Flash.apply(q, k, v, segment_ids, causal, block_q, block_kv, mode)
