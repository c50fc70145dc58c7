"""Plain PyTorch versions of the segment flash-attention forward and backward.

``segment_flash_attention_ref`` materializes the scores with the shared
masking contract: key j is visible to query i iff segment ids match (0 =
padding) and (causal => j <= i).  GQA by head grouping.  It repeats the
kernels' arithmetic in fp32 (inputs upcast, fp32 softmax statistics) and
their contract for rows with no visible key: output 0 and ``lse = NEG_INF``
(``l == 0``).

``segment_flash_attention_bwd_ref`` is the backward from the forward's saved
``(out, lse)``, as the kernels compute it: ``p = exp(scale·q·k - lse)`` built
under the mask, ``delta = rowsum(dO ⊙ O)``, ``ds = p ⊙ (dO·vᵀ - delta)``, all
in fp32.  A row with no visible key gives exactly zero dq and adds nothing to
dk/dv.

The CPU path of the kernel wrappers, the tests and ``chip_smoke.py`` use
them; nothing on the card's main path does.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _allowed(segment_ids, b: int, s: int, causal: bool, device) -> torch.Tensor:
    """(B, 1, 1, S, S) boolean allow-mask, broadcast over (kv head, group)."""
    allowed = torch.ones((b, s, s), dtype=torch.bool, device=device)
    if causal:
        pos = torch.arange(s, device=device)
        allowed &= pos[None, None, :] <= pos[None, :, None]
    if segment_ids is not None:
        allowed &= (segment_ids[:, :, None] == segment_ids[:, None, :]) & (
            segment_ids[:, None, :] > 0
        )
    return allowed[:, None, None]


def _per_q_row(x: torch.Tensor, kv: int) -> torch.Tensor:
    """(B, S, H) per-row statistic → (B, KV, G, S, 1), the scores' layout."""
    b, s, h = x.shape
    return x.float().reshape(b, s, kv, h // kv).permute(0, 2, 3, 1)[..., None]


def segment_flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    segment_ids: torch.Tensor | None = None,  # (B, S) int32; 0 = padding
    causal: bool = True,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Returns ``out`` (q's dtype), and with ``return_lse`` also the fp32
    ``lse = m + log(l)`` of shape (B, S, H)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qg = q.float().reshape(b, s, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    allowed = _allowed(segment_ids, b, s, causal, q.device)
    scores = torch.where(allowed, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF, 0.0, m)
    p = torch.where(allowed, torch.exp(scores - safe_m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / denom, v.float())
    out = out.reshape(b, s, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0.0, m + torch.log(denom), NEG_INF)[..., 0]
    return out, lse.permute(0, 3, 1, 2).reshape(b, s, h)


def segment_flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    segment_ids: torch.Tensor | None,  # (B, S) int32; 0 = padding
    out: torch.Tensor,  # (B, S, H, D) — the forward's output
    lse: torch.Tensor,  # (B, S, H) fp32 — the forward's log-sum-exp
    do: torch.Tensor,  # (B, S, H, D) — cotangent of out
    causal: bool = True,
    scale: float | None = None,
):
    """Returns ``(dq, dk, dv)`` in the dtypes of ``(q, k, v)``."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qg = q.float().reshape(b, s, kv, g, d)
    dog = do.float().reshape(b, s, kv, g, d)
    kf, vf = k.float(), v.float()
    delta = (do.float() * out.float()).sum(dim=-1)  # (B, S, H)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    allowed = _allowed(segment_ids, b, s, causal, q.device)
    p = torch.where(allowed, torch.exp(scores - _per_q_row(lse, kv)), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - _per_q_row(delta, kv))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, d) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
