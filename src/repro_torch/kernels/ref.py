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

``ssd_scan_ref`` is the Mamba-2 SSD as its token-level recurrence, and
``ssd_chunked_ref`` the same function chunk by chunk, the arithmetic of the
SSD kernel (K7): a within-chunk quadratic term, the carried state's term and
the state update, all in fp32, with an optional initial state and the final
state returned.

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


def ssd_scan_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) positive
    a: torch.Tensor,  # (H,) negative decay rates
    b_proj: torch.Tensor,  # (B, S, N)
    c_proj: torch.Tensor,  # (B, S, N)
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
):
    """Token-level recurrence: h_t = exp(a·dt_t)·h_{t-1} + dt_t·B_t⊗x_t;
    y_t = C_t · h_t.  Returns (y (B,S,H,P) in x's dtype, fp32 final state)."""
    bsz, s, h, p = x.shape
    n = b_proj.shape[-1]
    if initial_state is None:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    else:
        state = initial_state.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        decay = torch.exp(a[None, :].float() * dtt)  # (B, H)
        upd = torch.einsum("bn,bh,bhp->bhpn", b_proj[:, t].float(), dtt, x[:, t].float())
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_proj[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked_ref(
    x: torch.Tensor,  # (B, S, H, P)
    adt: torch.Tensor,  # (B, S, H) fp32: a·dt
    dt: torch.Tensor,  # (B, S, H) fp32
    b_proj: torch.Tensor,  # (B, S, N)
    c_proj: torch.Tensor,  # (B, S, N)
    chunk: int,  # divides S
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
):
    """The SSD chunk by chunk, as the kernel computes it (fp32 throughout):

        acs   = cumsum(adt) within the chunk
        y_i   = Σ_{j≤i} exp(acs_i − acs_j)·(C_i·B_j)·dt_j·x_j + exp(acs_i)·(C_i·state)
        state ← exp(acs_last)·state + Σ_j exp(acs_last − acs_j)·dt_j·x_j ⊗ B_j

    Above the diagonal (j > i) the difference acs_i − acs_j is positive and
    its exp may overflow, so the difference is masked to −inf *before* the
    exp, as the JAX package's ``_segsum`` does: the decay there is exactly
    0, and so is its gradient (a mask after the exp would hand 0 to the
    backward of an inf, 0·inf = NaN).  Returns (y in x's dtype, fp32 final
    state)."""
    bsz, s, h, p = x.shape
    n = b_proj.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if initial_state is None:
        state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    else:
        state = initial_state.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        xq = x[:, c0:c0 + chunk].float()  # (B, Q, H, P)
        dtq = dt[:, c0:c0 + chunk].float()  # (B, Q, H)
        bq = b_proj[:, c0:c0 + chunk].float()  # (B, Q, N)
        cq = c_proj[:, c0:c0 + chunk].float()
        acs = torch.cumsum(adt[:, c0:c0 + chunk].float(), dim=1)  # (B, Q, H)
        acs_h = acs.transpose(1, 2)  # (B, H, Q)
        l_mat = torch.exp(torch.where(tri, acs_h[..., :, None] - acs_h[..., None, :], -torch.inf))
        scores = torch.einsum("bqn,bsn->bqs", cq, bq)  # (B, Q, Q)
        w = l_mat * scores[:, None] * dtq.transpose(1, 2)[:, :, None, :]  # (B, H, Q, Q)
        y_diag = torch.einsum("bhqs,bshp->bqhp", w, xq)
        y_off = torch.einsum("bqn,bhpn->bqhp", cq, state) * torch.exp(acs)[..., None]
        chunk_decay = torch.exp(acs[:, -1:, :] - acs) * dtq  # (B, Q, H)
        state = state * torch.exp(acs[:, -1, :])[:, :, None, None] + torch.einsum(
            "bqhp,bqn->bhpn", xq * chunk_decay[..., None], bq
        )
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), state
