"""Gradient compression with error feedback for the data-parallel step.

The data-parallel step's gradient all-reduce is explicit, so it can be
compressed: fp32 gradients plus the carried residual are cast to bf16 before
the reduce, and the quantization residual stays in fp32 for the next step
(error feedback keeps the scheme unbiased over time — Karimireddy et al.,
"Error Feedback Fixes SignSGD").  It halves the reduce's bytes and composes
with ODB, which changes batch geometry, not the reduction.

Trees are nested dicts of tensors, as the optimizer's.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map


def init_error_state(grads_like: Any) -> Any:
    """Zero fp32 residuals shaped like ``grads_like``, on its devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like)


def compress_decompress(grads: Any, error: Any, *, dtype=torch.bfloat16) -> tuple[Any, Any]:
    """Returns (the compressed gradients in ``dtype``, the new fp32 residuals)."""
    out = {}
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        g32 = g.float() + e
        gq = g32.to(dtype)
        out[id(g)] = gq, g32 - gq.float()
    return tree_map(lambda g: out[id(g)][0], grads), tree_map(lambda g: out[id(g)][1], grads)


def all_reduce_sum(tree: Any, *, dtype=torch.float32) -> Any:
    """Sum a tree of tensors over the default process group in one
    all-reduce of its leaves flattened in ``dtype``; each sum comes back in
    its leaf's dtype."""
    import torch.distributed as dist

    leaves = tree_leaves(tree)
    flat = torch.cat([g.to(dtype).reshape(-1) for g in leaves])
    dist.all_reduce(flat)
    sums = dict(zip(map(id, leaves), flat.split([g.numel() for g in leaves])))
    return tree_map(lambda g: sums[id(g)].view(g.shape).to(g.dtype), tree)


def all_reduce_compressed(grads: Any, error: Any) -> tuple[Any, Any]:
    """Compress, sum the bf16 gradients over the default process group in
    one all-reduce, widen the sums to fp32; returns (reduced fp32 gradients,
    new residuals)."""
    compressed, new_error = compress_decompress(grads, error)
    reduced = all_reduce_sum(compressed, dtype=torch.bfloat16)
    return tree_map(lambda g: g.float(), reduced), new_error
