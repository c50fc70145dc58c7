"""Public flash-attention entry: resolves the block pair and the kernel once.

``grid`` ∈ {dense, pruned, auto} picks between the dense-loop kernel and the
pruned kernel that loads only live kv tiles.  ``auto`` resolves to pruned
exactly when segment ids are present and the tensors lie on a CUDA device;
an explicit ``pruned`` is honored wherever segments exist, and degrades to
dense without them (there is nothing to build liveness from).  Forward only:
serving needs no gradient.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention import (
    resolve_blocks,
    segment_flash_attention,
    segment_flash_attention_pruned,
)

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


def flash_attention(
    q, k, v, segment_ids=None, causal=True, block_q=128, block_kv=128,
    grid="auto",
):
    """Segment-masked attention of (B, S, H, D) q over (B, S, KV, D) k/v."""
    s = q.shape[1]
    block_q, block_kv = resolve_blocks(s, block_q, block_kv)
    fwd = (
        segment_flash_attention_pruned
        if resolve_grid(grid, segment_ids) == "pruned"
        else segment_flash_attention
    )
    return fwd(
        q, k, v, segment_ids, causal=causal, block_q=block_q, block_kv=block_kv
    )
