"""Plain PyTorch version of the segment flash-attention forward.

``segment_flash_attention_ref`` materializes the scores with the shared
masking contract: key j is visible to query i iff segment ids match (0 =
padding) and (causal => j <= i).  GQA by head grouping.  It repeats the
kernels' arithmetic in fp32 (inputs upcast, fp32 softmax statistics) and
their contract for rows with no visible key: output 0 and ``lse = NEG_INF``
(``l == 0``).  The CPU path of the kernel wrappers, the tests and
``chip_smoke.py`` use it; nothing on the card's main path does.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


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
    allowed = torch.ones((b, s, s), dtype=torch.bool, device=q.device)
    if causal:
        pos = torch.arange(s, device=q.device)
        allowed &= pos[None, None, :] <= pos[None, :, None]
    if segment_ids is not None:
        allowed &= (segment_ids[:, :, None] == segment_ids[:, None, :]) & (
            segment_ids[:, None, :] > 0
        )
    allowed = allowed[:, None, None]
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
