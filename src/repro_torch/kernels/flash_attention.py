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

Both backward wrappers take the forward's ``(out, lse)`` and compute
``delta = rowsum(dO ⊙ O)`` in fp32 as one PyTorch reduction before the
kernels.  All six are built for ``sm_90a`` at first use
(``kernels/build.py``).

A wrapper given CUDA tensors launches its kernels or raises; given CPU
tensors it computes the plain version (``kernels/ref.py``).  Each launch adds
one to its entry in :data:`LAUNCHES`, so a run can show which kernels its main
path went through.  Block sizes follow ``select_block``: the largest divisor of S that
is at most 128, preferring multiples of 8, so the liveness tables equal the
JAX package's for every shape.
"""

from __future__ import annotations

import ctypes

import torch

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


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _outputs(q, return_lse):
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device) if return_lse else None
    return out, lse


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = lib.flash_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _tables_for(segment_ids, tables, block_q: int, block_kv: int, causal: bool):
    """The liveness tables of this grid, built from the segments when not
    given, checked against the grid (B, S/block_q, S/block_kv)."""
    if tables is None:
        from repro_torch.kernels.liveness import build_liveness_tables

        tables = build_liveness_tables(
            segment_ids, block_q=block_q, block_kv=block_kv, causal=causal
        )
    b, s = segment_ids.shape
    nq, nk = s // block_q, s // block_kv
    shapes = ((b, nq, nk), (b, nq), (b, nk, nq), (b, nk))
    for t, shape in zip(tables, shapes):
        if t.shape != shape or t.dtype != torch.int32 or t.device != segment_ids.device:
            raise ValueError("liveness tables do not match the kernel grid")
    return tables


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
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_fwd")
    out, lse = _outputs(q, return_lse)
    b, s, h, _ = q.shape
    rc = lib.flash_fwd_dense(
        _DTYPES[q.dtype], q.device.index or 0,
        _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(out), _ptr(lse),
        b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale,
        _stream(q),
    )
    _raise_on(rc, lib, "segment_flash_attention")
    LAUNCHES["segment_flash_attention"] += 1
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
    tables = _tables_for(segment_ids, tables, block_q, block_kv, causal)
    kv_idx, kv_count = tables.kv_idx, tables.kv_count
    _check_cuda(q, k, v, segment_ids, kv_idx, kv_count)
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_fwd")
    out, lse = _outputs(q, return_lse)
    b, s, h, _ = q.shape
    rc = lib.flash_fwd_pruned(
        _DTYPES[q.dtype], q.device.index or 0,
        _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(kv_idx), _ptr(kv_count),
        _ptr(out), _ptr(lse),
        b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale,
        _stream(q),
    )
    _raise_on(rc, lib, "segment_flash_attention_pruned")
    LAUNCHES["segment_flash_attention_pruned"] += 1
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
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_bwd")
    delta, dq, dk, dv = _bwd_buffers(q, k, v, out, do)
    b, s, h, d = q.shape
    dims = (b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale, _stream(q))
    dev = (_DTYPES[q.dtype], q.device.index or 0)
    rc = lib.flash_bwd_dq_dense(
        *dev, _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dq), *dims,
    )
    _raise_on(rc, lib, "segment_flash_attention_bwd (dq)")
    LAUNCHES["segment_flash_attention_bwd_dq"] += 1
    rc = lib.flash_bwd_dkv_dense(
        *dev, _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dk), _ptr(dv), *dims,
    )
    _raise_on(rc, lib, "segment_flash_attention_bwd (dk/dv)")
    LAUNCHES["segment_flash_attention_bwd_dkv"] += 1
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
    tables = _tables_for(segment_ids, tables, block_q, block_kv, causal)
    _check_cuda(q, k, v, out, lse, do, segment_ids, *tables)
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_bwd")
    delta, dq, dk, dv = _bwd_buffers(q, k, v, out, do)
    b, s, h, d = q.shape
    dims = (b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale, _stream(q))
    dev = (_DTYPES[q.dtype], q.device.index or 0)
    rc = lib.flash_bwd_dq_pruned(
        *dev, _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(tables.kv_idx),
        _ptr(tables.kv_count), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), *dims,
    )
    _raise_on(rc, lib, "segment_flash_attention_bwd_pruned (dq)")
    LAUNCHES["segment_flash_attention_bwd_pruned_dq"] += 1
    rc = lib.flash_bwd_dkv_pruned(
        *dev, _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(tables.q_idx),
        _ptr(tables.q_count), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), *dims,
    )
    _raise_on(rc, lib, "segment_flash_attention_bwd_pruned (dk/dv)")
    LAUNCHES["segment_flash_attention_bwd_pruned_dkv"] += 1
    return dq, dk, dv
