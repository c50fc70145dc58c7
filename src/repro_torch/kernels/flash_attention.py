"""Segment-aware causal flash attention: wrappers over the CUDA kernels.

Forward, two kernels in ``csrc/flash_fwd.cu``:

* :func:`segment_flash_attention` — the dense loop: one thread block per
  ``(b, h, q-block)`` walks every kv block and skips the ones that are
  causally dead or segment-disjoint (the TPU kernel's ``_block_live`` rule);
* :func:`segment_flash_attention_pruned` — the same arithmetic over the
  compacted liveness tables (``kernels/liveness.py``): it visits only the
  live kv blocks, in ascending order, so it is bit-exact against the dense
  kernel while loading no dead tile.

Backward, four kernels in ``csrc/flash_bwd.cu``, two passes per grid:

* :func:`segment_flash_attention_bwd` — the q-stationary dQ pass and the
  kv-stationary dK/dV pass (GQA group summed inside, no atomics), each
  walking every block and skipping the dead ones;
* :func:`segment_flash_attention_bwd_pruned` — the same two passes over the
  row tables (dQ) and the column tables (dK/dV), bit-exact against the dense
  pair.

The dtype picks the route of every kernel.  In bf16 all six run on the
tensor cores (``mma.sync`` fed by a cp.async ring, one block per whole pinned
tile): the forward rounds P to bf16 before P·V (the softmax statistics and
``lse`` stay fp32); the dQ pass rounds scale·dS to one bf16 term before
dS·K; the dK/dV pass rounds P to bf16 and carries scale·dS as two bf16
terms.  They copy rows in 16-byte pieces, so they take head dims that are
multiples of 8 and 16-byte aligned inputs; the wrappers raise a
``ValueError`` otherwise, with no fallback.  In fp32 the products are fp32
fma chains on the CUDA cores (the exact rail).  Both backward wrappers take
the forward's ``(out, lse)`` and compute ``delta = rowsum(dO ⊙ O)`` in fp32
as one PyTorch reduction before the kernels.  All six are built for
``sm_90a`` at first use (``kernels/build.py``).

A wrapper given CUDA tensors launches its kernels or raises; given CPU
tensors it computes the plain version (``kernels/ref.py``).  Each launch adds
one to its entry in :data:`LAUNCHES`, so a run can show which kernels its main
path went through.  Block sizes follow ``select_block``: the largest divisor of S that
is at most 128, preferring multiples of 8, so the liveness tables equal the
JAX package's for every shape.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.ref import (
    NEG_INF,
    segment_flash_attention_bwd_ref,
    segment_flash_attention_ref,
)

_SEG_BIG = 1 << 30  # "no positive segment in this block" sentinel

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {
    "segment_flash_attention": 0,
    "segment_flash_attention_pruned": 0,
    "segment_flash_attention_bwd_dq": 0,
    "segment_flash_attention_bwd_dkv": 0,
    "segment_flash_attention_bwd_pruned_dq": 0,
    "segment_flash_attention_bwd_pruned_dkv": 0,
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = [
    "LAUNCHES",
    "NEG_INF",
    "live_tile_counts",
    "reset_launches",
    "resolve_blocks",
    "segment_flash_attention",
    "segment_flash_attention_bwd",
    "segment_flash_attention_bwd_pruned",
    "segment_flash_attention_pruned",
    "select_block",
]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def select_block(s: int, requested: int, cap: int = 128) -> int:
    """Largest block ≤ min(requested, cap) that divides ``s``.

    Divisors that are multiples of 8 are preferred (384 → 128, 200 → 40,
    96 → 96); shapes with no such divisor fall back to the largest divisor
    of any width.
    """
    b = min(requested, cap, s)
    unaligned = 1
    for c in range(b, 0, -1):
        if s % c:
            continue
        if c % 8 == 0:
            return c
        if unaligned == 1:
            unaligned = c
    return unaligned


def resolve_blocks(s: int, block_q: int, block_kv: int) -> tuple[int, int]:
    """One ``(block_q, block_kv)`` pair for sequence length ``s``.

    ``select_block`` is not idempotent on arbitrary requests
    (``select_block(120, 15) == 8``), so routing resolves once per shape and
    the kernels assert they were handed the fixed point.
    """
    return select_block(s, block_q), select_block(s, block_kv)


def _check_resolved(s: int, block_q: int, block_kv: int) -> None:
    if (block_q, block_kv) != resolve_blocks(s, block_q, block_kv):
        raise ValueError(
            f"block pair ({block_q}, {block_kv}) is not resolved for S={s}: "
            "routing must pin resolve_blocks() once and pass the fixed point"
        )


def _check_inputs(q, k, v, segment_ids, block_q, block_kv):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape != (b, s, kv, d) or v.shape != k.shape or h % kv:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    if segment_ids is not None and (
        segment_ids.shape != (b, s) or segment_ids.dtype != torch.int32
    ):
        raise ValueError("segment_ids must be (B, S) int32")
    tensors = [q, k, v] + ([segment_ids] if segment_ids is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v and segment_ids must lie on one device")
    _check_resolved(s, block_q, block_kv)


def _check_cuda(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    if tensors[0].dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {tensors[0].dtype}")
    b, s, h, d = tensors[0].shape
    if d > 128:
        raise ValueError(f"head dim {d} > 128 is not supported by the CUDA kernels")


def _check_tc_cuda(direction: str, **tensors: torch.Tensor) -> None:
    """The bf16 kernels (all on the tensor cores) copy rows in 16-byte
    pieces: they take head dims that are multiples of 8 and 16-byte aligned
    inputs."""
    first = next(iter(tensors.values()))
    if first.dtype != torch.bfloat16:
        return
    if first.shape[-1] % 8:
        raise ValueError(
            f"the bf16 {direction} kernels take head dims that are multiples of 8, got {first.shape[-1]}"
        )
    if any(t.data_ptr() % 16 for t in tensors.values()):
        *rest, last = tensors
        raise ValueError(f"the bf16 {direction} kernels take 16-byte aligned {', '.join(rest)} and {last}")


def _outputs(q, return_lse):
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device) if return_lse else None
    return out, lse


def segment_flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    segment_ids: torch.Tensor | None = None,  # (B, S) int32; 0 = padding
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
    return_lse: bool = False,
):
    """Dense-loop forward (replaces the TPU ``segment_flash_attention``).

    ``block_q``/``block_kv`` must be resolved (``resolve_blocks``).  Returns
    ``out`` and, with ``return_lse``, the fp32 ``lse`` of shape (B, S, H).
    """
    _check_inputs(q, k, v, segment_ids, block_q, block_kv)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return segment_flash_attention_ref(q, k, v, segment_ids, causal, scale, return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    _check_cuda(q, k, v, *([segment_ids] if segment_ids is not None else []))
    _check_tc_cuda("forward", q=q, k=k, v=v)
    out, lse = _outputs(q, return_lse)
    b, s, h, _ = q.shape
    launch(load_library("flash_fwd"), "flash_fwd_dense", _DTYPES[q.dtype], q.device.index or 0,
           q, k, v, segment_ids, out, lse, b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale,
           device=q.device, launches=LAUNCHES, name="segment_flash_attention")
    return (out, lse) if return_lse else out


def segment_flash_attention_pruned(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    segment_ids: torch.Tensor,  # (B, S) int32; 0 = padding — required
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
    return_lse: bool = False,
    tables=None,
):
    """Live-tile forward (replaces the TPU ``segment_flash_attention_pruned``).

    Visits only the live kv blocks of ``tables`` (built here from the
    segments when not given); bit-exact against
    :func:`segment_flash_attention` on the card.
    """
    if segment_ids is None:
        raise ValueError("the pruned kernel needs segment ids")
    _check_inputs(q, k, v, segment_ids, block_q, block_kv)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return segment_flash_attention_ref(q, k, v, segment_ids, causal, scale, return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    from repro_torch.kernels.liveness import liveness_tables

    tables = liveness_tables(segment_ids, block_q, block_kv, causal, tables)
    _check_cuda(q, k, v, segment_ids)
    _check_tc_cuda("forward", q=q, k=k, v=v)
    out, lse = _outputs(q, return_lse)
    b, s, h, _ = q.shape
    launch(load_library("flash_fwd"), "flash_fwd_pruned", _DTYPES[q.dtype], q.device.index or 0,
           q, k, v, segment_ids, tables.kv_idx, tables.kv_count, out, lse,
           b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale,
           device=q.device, launches=LAUNCHES, name="segment_flash_attention_pruned")
    return (out, lse) if return_lse else out


def _check_residuals(q, out, lse, do) -> None:
    b, s, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} must match q {tuple(q.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("out and do must share q's dtype")
    if lse.shape != (b, s, h) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, S, H) float32, got {tuple(lse.shape)} {lse.dtype}")
    if len({t.device for t in (q, out, lse, do)}) != 1:
        raise ValueError("q, out, lse and do must lie on one device")


def _bwd_setup(q, k, v, segment_ids, out, lse, do, block_q, block_kv, scale):
    """Shared checks of both backward wrappers; returns the resolved scale."""
    _check_inputs(q, k, v, segment_ids, block_q, block_kv)
    _check_residuals(q, out, lse, do)
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {q.device}")
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _bwd_buffers(q, k, v, out, do):
    """``delta = rowsum(dO ⊙ O)`` in fp32 (one PyTorch reduction, as the TPU
    path computes it outside its kernels) and the three gradient outputs."""
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    return delta, torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def segment_flash_attention_bwd(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    segment_ids: torch.Tensor | None,  # (B, S) int32; 0 = padding
    out: torch.Tensor,  # (B, S, H, D) — the forward's output
    lse: torch.Tensor,  # (B, S, H) fp32 — the forward's log-sum-exp
    do: torch.Tensor,  # (B, S, H, D) — cotangent of out
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
):
    """Dense-loop backward (replaces the TPU ``segment_flash_attention_bwd``):
    the dQ pass, then the dK/dV pass.  Returns ``(dq, dk, dv)``."""
    scale = _bwd_setup(q, k, v, segment_ids, out, lse, do, block_q, block_kv, scale)
    if q.device.type == "cpu":
        return segment_flash_attention_bwd_ref(q, k, v, segment_ids, out, lse, do, causal, scale)
    segs = [segment_ids] if segment_ids is not None else []
    _check_cuda(q, k, v, out, lse, do, *segs)
    _check_tc_cuda("backward", q=q, k=k, v=v, do=do)
    lib = load_library("flash_bwd")
    delta, dq, dk, dv = _bwd_buffers(q, k, v, out, do)
    b, s, h, d = q.shape
    head = (_DTYPES[q.dtype], q.device.index or 0, q, k, v, segment_ids, do, lse, delta)
    dims = (b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale)
    kw = dict(device=q.device, launches=LAUNCHES)
    launch(lib, "flash_bwd_dq_dense", *head, dq, *dims, name="segment_flash_attention_bwd_dq", **kw)
    launch(lib, "flash_bwd_dkv_dense", *head, dk, dv, *dims, name="segment_flash_attention_bwd_dkv", **kw)
    return dq, dk, dv


def segment_flash_attention_bwd_pruned(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    segment_ids: torch.Tensor,  # (B, S) int32; 0 = padding — required
    out: torch.Tensor,  # (B, S, H, D)
    lse: torch.Tensor,  # (B, S, H) fp32
    do: torch.Tensor,  # (B, S, H, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
    tables=None,
):
    """Live-tile backward (replaces the TPU
    ``segment_flash_attention_bwd_pruned``): the dQ pass over the row tables,
    the dK/dV pass over the column tables; bit-exact against
    :func:`segment_flash_attention_bwd` on the card."""
    if segment_ids is None:
        raise ValueError("the pruned kernels need segment ids")
    scale = _bwd_setup(q, k, v, segment_ids, out, lse, do, block_q, block_kv, scale)
    if q.device.type == "cpu":
        return segment_flash_attention_bwd_ref(q, k, v, segment_ids, out, lse, do, causal, scale)
    from repro_torch.kernels.liveness import liveness_tables

    tables = liveness_tables(segment_ids, block_q, block_kv, causal, tables)
    _check_cuda(q, k, v, out, lse, do, segment_ids)
    _check_tc_cuda("backward", q=q, k=k, v=v, do=do)
    lib = load_library("flash_bwd")
    delta, dq, dk, dv = _bwd_buffers(q, k, v, out, do)
    b, s, h, d = q.shape
    head = (_DTYPES[q.dtype], q.device.index or 0, q, k, v, segment_ids)
    resid = (do, lse, delta)
    dims = (b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale)
    kw = dict(device=q.device, launches=LAUNCHES)
    launch(lib, "flash_bwd_dq_pruned", *head, tables.kv_idx, tables.kv_count, *resid, dq, *dims,
           name="segment_flash_attention_bwd_pruned_dq", **kw)
    launch(lib, "flash_bwd_dkv_pruned", *head, tables.q_idx, tables.q_count, *resid, dk, dv, *dims,
           name="segment_flash_attention_bwd_pruned_dkv", **kw)
    return dq, dk, dv


def _host_segments(segment_ids):
    """A (B, S) numpy copy of segment ids given as a tensor (on any device)
    or an array."""
    import numpy as np

    if isinstance(segment_ids, torch.Tensor):
        return segment_ids.detach().cpu().numpy()
    return np.asarray(segment_ids)


def live_tile_counts(
    segment_ids, s: int, block_q: int, block_kv: int, causal: bool = True
) -> dict:
    """Host-side mirror of the kernels' block-skip rule (census and tests).

    Counts (row, q-block, kv-block) tiles that survive (a) the causal skip
    alone and (b) causal + segment-range skipping, for a (B, S) segment-id
    array.  Pure numpy, block sizes resolved by ``select_block`` as the
    kernels resolve them.  ``segment_live`` is the number of tiles the pruned
    kernels (K4-K6) visit: the live entries of the liveness tables, summed
    over rows and q-blocks; ``causal_live`` is what the dense grid (K1-K3)
    does not skip on the causal test alone.  Sets the
    ``kernel_live_tile_fraction`` gauges (``mode=causal|segment``).
    """
    seg = _host_segments(segment_ids)
    bsz = seg.shape[0]
    block_q = select_block(s, block_q)
    block_kv = select_block(s, block_kv)
    nq, nk = s // block_q, s // block_kv
    total = bsz * nq * nk
    causal_live = 0
    seg_live = 0
    for i in range(bsz):
        for qb in range(nq):
            qs = seg[i, qb * block_q : (qb + 1) * block_q]
            q_pos = qs[qs > 0]
            for kb in range(nk):
                if causal and qb * block_q + block_q - 1 < kb * block_kv:
                    continue
                causal_live += 1
                ks = seg[i, kb * block_kv : (kb + 1) * block_kv]
                k_pos = ks[ks > 0]
                if (
                    q_pos.size
                    and k_pos.size
                    and q_pos.max() >= k_pos.min()
                    and k_pos.max() >= q_pos.min()
                ):
                    seg_live += 1
    out = {
        "tiles": total,
        "block_q": block_q,
        "block_kv": block_kv,
        "causal_live": causal_live,
        "segment_live": seg_live,
        "causal_live_fraction": causal_live / total if total else 0.0,
        "segment_live_fraction": seg_live / total if total else 0.0,
    }
    from repro_torch import obs  # deferred: keep kernel import time lean

    obs.gauge(
        "kernel_live_tile_fraction",
        help="fraction of attention tiles surviving the block-skip rule",
        mode="causal",
    ).set(out["causal_live_fraction"])
    obs.gauge(
        "kernel_live_tile_fraction", mode="segment"
    ).set(out["segment_live_fraction"])
    return out
