"""Segment-aware causal flash attention forward: wrappers over the CUDA kernels.

Two kernels in ``csrc/flash_fwd.cu``, built for ``sm_90a`` at first use
(``kernels/build.py``):

* :func:`segment_flash_attention` — the dense loop: one thread block per
  ``(b, h, q-block)`` walks every kv block and skips the ones that are
  causally dead or segment-disjoint (the TPU kernel's ``_block_live`` rule);
* :func:`segment_flash_attention_pruned` — the same arithmetic over the
  compacted liveness tables (``kernels/liveness.py``): it visits only the
  live kv blocks, in ascending order, so it is bit-exact against the dense
  kernel while loading no dead tile.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it computes the plain version (``kernels/ref.py``).  Each launch adds
one to :data:`LAUNCHES`, so a run can show which kernels its main path went
through.  Block sizes follow ``select_block``: the largest divisor of S that
is at most 128, preferring multiples of 8, so the liveness tables equal the
JAX package's for every shape.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import NEG_INF, segment_flash_attention_ref

_SEG_BIG = 1 << 30  # "no positive segment in this block" sentinel

# Kernel launches since the last reset_launches(), by wrapper name.
LAUNCHES = {"segment_flash_attention": 0, "segment_flash_attention_pruned": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = [
    "LAUNCHES",
    "NEG_INF",
    "reset_launches",
    "resolve_blocks",
    "segment_flash_attention",
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
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
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
    if tables is None:
        from repro_torch.kernels.liveness import build_liveness_tables

        tables = build_liveness_tables(
            segment_ids, block_q=block_q, block_kv=block_kv, causal=causal
        )
    b, s, h, _ = q.shape
    nq, nk = s // block_q, s // block_kv
    kv_idx, kv_count = tables.kv_idx, tables.kv_count
    if (
        kv_idx.shape != (b, nq, nk) or kv_count.shape != (b, nq)
        or kv_idx.dtype != torch.int32 or kv_count.dtype != torch.int32
        or kv_idx.device != q.device or kv_count.device != q.device
    ):
        raise ValueError("liveness tables do not match the kernel grid")
    _check_cuda(q, k, v, segment_ids, kv_idx, kv_count)
    from repro_torch.kernels.build import load_library

    lib = load_library("flash_fwd")
    out, lse = _outputs(q, return_lse)
    rc = lib.flash_fwd_pruned(
        _DTYPES[q.dtype], q.device.index or 0,
        _ptr(q), _ptr(k), _ptr(v), _ptr(segment_ids), _ptr(kv_idx), _ptr(kv_count),
        _ptr(out), _ptr(lse),
        b, s, h, k.shape[2], d, block_q, block_kv, int(causal), scale,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, lib, "segment_flash_attention_pruned")
    LAUNCHES["segment_flash_attention_pruned"] += 1
    return (out, lse) if return_lse else out
