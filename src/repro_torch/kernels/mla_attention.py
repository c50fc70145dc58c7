"""MLA's segment flash attention: the wrapper over ``csrc/mla_attention.cu``.

Multi-head latent attention in the direct form (DeepSeek-V2 and -V3) over
packed segments, cache-free: per head, q and k have ``NOPE + ROPE`` = 192
columns and v and the output ``V_DIM`` = 128, and the last 64 columns of
every head's key are one rope key ``k_rope`` (B, S, 64) shared by all heads.
The masking contract is the flash kernels' (``kernels/flash_attention``):
key j is visible to query i iff the segment ids match, the key's id is > 0
and (causal ⇒ j ≤ i, by absolute row); a row with no visible key gives out 0,
``lse`` = NEG_INF and zero gradients.

Three kernels over the liveness tables of one block pair
(``kernels/liveness``), built once a forward:

* ``mla_fwd`` — out (B, S, H, 128) and fp32 ``lse`` (B, S, H);
* ``mla_bwd_dq`` — dq (B, S, H, 192);
* ``mla_bwd_dkv`` — dk_nope and dv (B, S, H, 128), and each head's rope
  columns of dk in fp32 (B, S, H, 64), which :func:`mla_attention_bwd` sums
  over the heads in fp32 (one reduction, no atomics) into dk_rope (B, S, 64).

:func:`mla_attention` is differentiable through :class:`_MlaAttention`, an
autograd Function whose forward saves q, k_nope, k_rope, v, out, lse and the
tables, and whose backward is the two backward kernels.  The block pair is
fixed here from the sequence length (:func:`block_for`).

A wrapper given CUDA tensors launches its kernels or raises (bf16 only, the
shapes above, contiguous, 16-byte aligned, segment ids required); given CPU
tensors it computes the plain version (:func:`mla_attention_ref`,
:func:`mla_attention_bwd_ref`, any widths, the kernels' arithmetic in fp32).
Each launch adds one to its entry in :data:`LAUNCHES` and to the registry
counter ``kernel_mla_launches_total``, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.flash_attention import select_block
from repro_torch.kernels.liveness import LivenessTables, liveness_tables
from repro_torch.kernels.ref import NEG_INF

NOPE, ROPE, V_DIM = 128, 64, 128  # the widths the kernels take
BLOCK = 128  # the largest block; block_for picks the divisor of S the tables use

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"mla_fwd": 0, "mla_bwd_dq": 0, "mla_bwd_dkv": 0}
_COUNTER = ("kernel_mla_launches_total", "launches of the MLA attention kernels")

__all__ = [
    "LAUNCHES",
    "block_for",
    "mla_attention",
    "mla_attention_bwd",
    "mla_attention_bwd_ref",
    "mla_attention_fwd",
    "mla_attention_ref",
    "reset_launches",
]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_for(s: int) -> int:
    """The one block size of both sides of the tiles at sequence length
    ``s``: the flash kernels' choice (``select_block``), at most 128."""
    return select_block(s, BLOCK)


def _check_inputs(q, k_nope, k_rope, v, segment_ids) -> None:
    if q.dim() != 4 or k_nope.dim() != 4 or k_rope.dim() != 3 or v.dim() != 4:
        raise ValueError("q, k_nope and v must be (B, S, H, D) and k_rope (B, S, D)")
    b, s, h, qk = q.shape
    nope, rope = k_nope.shape[-1], k_rope.shape[-1]
    if (k_nope.shape[:3] != (b, s, h) or k_rope.shape[:2] != (b, s) or v.shape[:3] != (b, s, h)
            or qk != nope + rope):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_nope {tuple(k_nope.shape)} "
                         f"k_rope {tuple(k_rope.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k_nope.dtype == k_rope.dtype == v.dtype):
        raise ValueError("q, k_nope, k_rope and v must share a dtype")
    if segment_ids is None or segment_ids.shape != (b, s) or segment_ids.dtype != torch.int32:
        raise ValueError("segment_ids must be (B, S) int32")
    if len({t.device for t in (q, k_nope, k_rope, v, segment_ids)}) != 1:
        raise ValueError("q, k_nope, k_rope, v and segment_ids must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {q.device}")


def check_kernel_inputs(*rows: torch.Tensor) -> None:
    """What the kernels take beyond the shared checks: bf16, MLA's widths
    (q 192 = 128 + 64 columns a head, v 128), contiguous and 16-byte aligned
    (rows are copied in 16-byte pieces).  ``rows`` = q, k_nope, k_rope, v
    and any of the forward's out and the cotangent."""
    q, k_nope, k_rope, v = rows[:4]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the MLA kernels take bfloat16, got {q.dtype}")
    widths = (q.shape[-1], k_nope.shape[-1], k_rope.shape[-1], v.shape[-1])
    if widths != (NOPE + ROPE, NOPE, ROPE, V_DIM):
        raise ValueError(f"the MLA kernels take q/k_nope/k_rope/v widths "
                         f"{(NOPE + ROPE, NOPE, ROPE, V_DIM)}, got {widths}")
    if not all(t.is_contiguous() for t in rows):
        raise ValueError("the MLA kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError("the MLA kernels take 16-byte aligned tensors")


def _allowed(seg: torch.Tensor, causal: bool) -> torch.Tensor:
    """(S, S) allow-mask of one batch row: ids match, key id > 0, causal by row."""
    allowed = (seg[:, None] == seg[None, :]) & (seg[None, :] > 0)
    if causal:
        pos = torch.arange(seg.shape[0], device=seg.device)
        allowed &= pos[None, :] <= pos[:, None]
    return allowed


def _row_keys(k_nope: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """One batch row's per-head keys in fp32, (S, H, nope + rope): the shared
    rope key repeated for every head, as the kernels assemble each tile."""
    s, h, _ = k_nope.shape
    return torch.cat([k_nope.float(), k_rope.float()[:, None].expand(s, h, -1)], dim=-1)


def mla_attention_ref(q, k_nope, k_rope, v, segment_ids, causal: bool, scale: float):
    """The plain forward: ``(out, lse)`` in q's dtype and fp32, one batch row
    at a time (the scores of a row are (H, S, S) in fp32)."""
    outs, lses = [], []
    for i in range(q.shape[0]):
        k = _row_keys(k_nope[i], k_rope[i])
        scores = torch.einsum("qhd,shd->hqs", q[i].float(), k) * scale
        allowed = _allowed(segment_ids[i], causal)
        scores = torch.where(allowed, scores, NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        safe_m = torch.where(m <= NEG_INF, 0.0, m)
        p = torch.where(allowed, torch.exp(scores - safe_m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        denom = torch.where(l == 0.0, 1.0, l)
        outs.append(torch.einsum("hqs,shd->qhd", p / denom, v[i].float()))
        lses.append(torch.where(l > 0.0, m + torch.log(denom), NEG_INF)[..., 0].T)
    return torch.stack(outs).to(q.dtype), torch.stack(lses)


def mla_attention_bwd_ref(q, k_nope, k_rope, v, segment_ids, out, lse, do, causal: bool, scale: float):
    """The plain backward from the forward's ``(out, lse)``, as the kernels
    compute it, in fp32: P = exp(scale q.k - lse) under the mask, delta =
    rowsum(dO ⊙ O), dS = P (dO.vᵀ - delta); each head's dk, whose rope
    columns are summed over the heads into dk_rope.  Returns ``(dq, dk_nope,
    dk_rope, dv)`` in the inputs' dtypes."""
    nope = k_nope.shape[-1]
    grads = []
    for i in range(q.shape[0]):
        qf, dof = q[i].float(), do[i].float()
        k = _row_keys(k_nope[i], k_rope[i])
        delta = (dof * out[i].float()).sum(dim=-1).T[..., None]  # (H, S, 1)
        scores = torch.einsum("qhd,shd->hqs", qf, k) * scale
        p = torch.where(_allowed(segment_ids[i], causal), torch.exp(scores - lse[i].T[..., None]), 0.0)
        ds = p * (torch.einsum("qhd,shd->hqs", dof, v[i].float()) - delta)
        dq = torch.einsum("hqs,shd->qhd", ds, k) * scale
        dk = torch.einsum("hqs,qhd->shd", ds, qf) * scale
        dv = torch.einsum("hqs,qhd->shd", p, dof)
        grads.append((dq, dk[..., :nope], dk[..., nope:].sum(dim=1), dv))
    return tuple(torch.stack(g).to(t.dtype) for g, t in zip(zip(*grads), (q, k_nope, k_rope, v)))


def _launch(fn: str, q, *args, block: int, causal: bool, scale: float) -> None:
    """One launch of kernel ``fn``: (device, q, ``args``, B, S, H, bq, bkv, causal, scale, stream)."""
    b, s, h, _ = q.shape
    launch(load_library("mla_attention"), fn, q.device.index or 0, q, *args, b, s, h, block, block,
           int(causal), scale, device=q.device, launches=LAUNCHES, counter=_COUNTER)


def mla_attention_fwd(q, k_nope, k_rope, v, segment_ids, *, causal: bool = True, scale: float | None = None,
                      tables=None):
    """``(out, lse)``: the forward kernel over the liveness tables at
    :func:`block_for`'s block (built here when not given), or the plain
    version on CPU tensors."""
    _check_inputs(q, k_nope, k_rope, v, segment_ids)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mla_attention_ref(q, k_nope, k_rope, v, segment_ids, causal, scale)
    check_kernel_inputs(q, k_nope, k_rope, v)
    block = block_for(q.shape[1])
    tables = liveness_tables(segment_ids, block, block, causal, tables)
    b, s, h, _ = q.shape
    out = torch.empty((b, s, h, V_DIM), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    _launch("mla_fwd", q, k_nope, k_rope, v, segment_ids, tables.kv_idx, tables.kv_count, out, lse,
            block=block, causal=causal, scale=scale)
    return out, lse


def mla_attention_bwd(q, k_nope, k_rope, v, segment_ids, out, lse, do, *, causal: bool = True,
                      scale: float | None = None, tables=None):
    """``(dq, dk_nope, dk_rope, dv)`` from the forward's ``(out, lse)`` and
    the cotangent ``do``: the dQ and dK/dV kernels (``delta = rowsum(dO ⊙ O)``
    in fp32 before them, the heads' rope partials summed after), or the plain
    version on CPU tensors."""
    _check_inputs(q, k_nope, k_rope, v, segment_ids)
    b, s, h, _ = q.shape
    if out.shape != v.shape or do.shape != v.shape or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} must match v {tuple(v.shape)} "
                         "in q's dtype")
    if lse.shape != (b, s, h) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, S, H) float32, got {tuple(lse.shape)} {lse.dtype}")
    if len({t.device for t in (q, out, lse, do)}) != 1:
        raise ValueError("q, out, lse and do must lie on one device")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mla_attention_bwd_ref(q, k_nope, k_rope, v, segment_ids, out, lse, do, causal, scale)
    check_kernel_inputs(q, k_nope, k_rope, v, out, do)
    if not lse.is_contiguous():
        raise ValueError("the MLA kernels take contiguous tensors")
    block = block_for(s)
    tables = liveness_tables(segment_ids, block, block, causal, tables)
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = torch.empty_like(q)
    dk_nope, dv = torch.empty_like(k_nope), torch.empty_like(v)
    dk_rope_heads = torch.empty((b, s, h, ROPE), dtype=torch.float32, device=q.device)
    inputs = (q, k_nope, k_rope, v, segment_ids)
    grid = dict(block=block, causal=causal, scale=scale)
    _launch("mla_bwd_dq", *inputs, tables.kv_idx, tables.kv_count, do, lse, delta, dq, **grid)
    _launch("mla_bwd_dkv", *inputs, tables.q_idx, tables.q_count, do, lse, delta, dk_nope, dk_rope_heads, dv,
            **grid)
    return dq, dk_nope, dk_rope_heads.sum(dim=2).to(k_rope.dtype), dv


class _MlaAttention(torch.autograd.Function):
    """out = MLA(q, k_nope, k_rope, v) under the segment mask: the forward
    kernel, and the two backward kernels from the saved inputs, out, lse and
    liveness tables (built once, in the forward)."""

    @staticmethod
    def forward(ctx, q, k_nope, k_rope, v, segment_ids, causal, scale):
        tables = None  # the plain version on CPU tensors needs none; without segments the wrapper raises
        if q.device.type == "cuda" and segment_ids is not None:
            block = block_for(q.shape[1])
            tables = liveness_tables(segment_ids, block, block, causal)
        out, lse = mla_attention_fwd(q, k_nope, k_rope, v, segment_ids, causal=causal, scale=scale,
                                     tables=tables)
        ctx.save_for_backward(q, k_nope, k_rope, v, segment_ids, out, lse, *(tables or ()))
        ctx.config = (causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k_nope, k_rope, v, segment_ids, out, lse, *tables = ctx.saved_tensors
        causal, scale = ctx.config
        grads = mla_attention_bwd(q, k_nope, k_rope, v, segment_ids, out, lse, do.contiguous(),
                                  causal=causal, scale=scale,
                                  tables=LivenessTables(*tables) if tables else None)
        return (*grads, None, None, None)


def mla_attention(q, k_nope, k_rope, v, segment_ids, causal: bool = True, scale: float | None = None):
    """Segment-masked MLA of q (B, S, H, nope + rope) over the per-head
    k_nope (B, S, H, nope), the shared k_rope (B, S, rope) and v (B, S, H,
    v_dim), differentiable in q, k_nope, k_rope and v; ``scale`` defaults to
    1/√(nope + rope)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _MlaAttention.apply(q, k_nope, k_rope, v, segment_ids, causal, scale)
