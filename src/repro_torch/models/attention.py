"""GQA attention with KV caches and segment masking.

Three paths: cache-free attention (training), the slot-scatter prefill
(serving) and the per-slot decode over the cache.  The first two have two
implementations behind one entry point: the plain blockwise masked attention
below (``attn_impl="xla"``, the name kept from the JAX package) and the
hand-written segment flash kernels in ``repro_torch.kernels``, whose
autograd backward is a kernel too.  ``use_flash_attention`` routes between
them from ``ArchConfig.attn_impl``; "auto" takes the kernel exactly when the
batch is packed and the tensors lie on a CUDA device.  Decode always takes
the plain path over the cache.

Masking contract (shared with the kernels): attention is allowed iff
``segment_ids`` match (padding carries segment 0) AND (causal ⇒ key position
≤ query position).  The kernels mask causally by absolute row; the plain
path by within-segment ``positions``.  The two agree because segments are
contiguous and positions restart at every segment start.

The KV cache is updated in place (the JAX package returns new arrays): the
cache is the largest state on the card, and a copy per layer per step would
double its traffic.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.layers import apply_rope, dense_init, rms_norm

Params = dict[str, Any]

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, n_kv, d_head)
    v: torch.Tensor  # (B, S_max, n_kv, d_head)


def make_attention_params(generator, cfg, dtype, device) -> Params:
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"attention kind {cfg.attn_kind!r} is not ported yet")
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p: Params = {
        "wq": dense_init(generator, d, h * dh, dtype, device),
        "wk": dense_init(generator, d, kv * dh, dtype, device),
        "wv": dense_init(generator, d, kv * dh, dtype, device),
        "wo": dense_init(generator, h * dh, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=device)
    return p


# ------------------------------------------------------------------------------
# Block masking
# ------------------------------------------------------------------------------


def _block_mask(q_pos, k_pos, q_seg, k_seg, k_limit, causal: bool):
    """(B, qb, Sk) boolean allow-mask computed per query block.

    ``k_limit`` (scalar or (B, 1, 1)): keys at positions >= limit are invalid.
    """
    allowed = torch.ones(
        (q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]), dtype=torch.bool, device=q_pos.device
    )
    if causal:
        allowed &= k_pos[:, None, :] <= q_pos[:, :, None]
    if q_seg is not None and k_seg is not None:
        allowed &= (q_seg[:, :, None] == k_seg[:, None, :]) & (k_seg[:, None, :] > 0)
    if k_limit is not None:
        allowed &= k_pos[:, None, :] < k_limit
    return allowed


def _pick_block(s: int, preferred: int = 256) -> int:
    for b in (preferred, 128, 64, 32, 16, 8, 4, 2, 1):
        if b <= s and s % b == 0:
            return b
    return 1


# ------------------------------------------------------------------------------
# Kernel routing: plain blockwise vs flash kernels
# ------------------------------------------------------------------------------


def use_flash_attention(cfg, segments, cache) -> bool:
    """Route this call through the segment flash kernels?

    Only cache-free attention (training, the packed prefill) matches the
    kernel contract.  "flash" forces the kernel (its plain version on CPU tensors),
    "xla" forces the plain path, "auto" takes the kernel when the batch is
    packed and the device is CUDA.
    """
    if cache is not None:
        return False
    impl = cfg.attn_impl
    if impl == "flash":
        return True
    if impl == "auto":
        return segments is not None and segments.device.type == "cuda"
    return False


def resolve_flash_grid(cfg, segments) -> str:
    """Concrete kernel variant for this call: ``attn_grid`` resolved against
    segment presence and the device."""
    from repro_torch.kernels.ops import resolve_grid

    return resolve_grid(cfg.attn_grid, segments)


def _flash_blocks(cfg, s: int, b: int, dtype, has_segments: bool, grid: str, device):
    """The (block_q, block_kv) schedule for one shape cell.

    With ``attn_autotune`` the measured probe picks it (``kernels/autotune``),
    keyed by the grid this call runs.  Under grad mode the forward only reads
    the cache: a training forward runs inside ``torch.utils.checkpoint``,
    whose saved-tensor hooks would capture the probe's own graph, so the
    trainer warms each new shape first (:func:`warm_flash_blocks`) and a miss
    here raises."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import select_block

    if cfg.attn_block_q or cfg.attn_block_kv:
        # Partial pins are honored: the unset side takes the heuristic width.
        return (
            select_block(s, cfg.attn_block_q or 128),
            select_block(s, cfg.attn_block_kv or 128),
        )
    if not cfg.attn_autotune:
        return autotune.heuristic_blocks(s)
    cell = (b, s, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    kw = dict(dtype=dtype, causal=cfg.causal, has_segments=has_segments, grid=grid)
    if not torch.is_grad_enabled():
        return autotune.autotune_blocks(*cell, **kw, device=device)
    key = autotune.shape_key(*cell, **kw, device=device)
    blocks = autotune.lookup_blocks(key)
    if blocks is None:
        raise RuntimeError(
            f"attn_autotune: no measured block schedule for {key} inside a recorded "
            "forward (the probe cannot run inside torch.utils.checkpoint); warm the "
            "shape first with models.attention.warm_flash_blocks(cfg, batch, dtype) "
            "outside autograd, as Trainer does before each new step shape"
        )
    return blocks


def warm_flash_blocks(cfg, batch: dict, dtype) -> None:
    """Run the measured block probe for the shape of ``batch`` (the model's
    ``tokens`` and, when packed, ``segments``) outside autograd, so the
    forward that follows finds its schedule in the cache.  A no-op unless
    ``attn_autotune`` is set and the batch takes the flash route."""
    segments = batch.get("segments")
    if not (cfg.attn_autotune and cfg.uses_attention
            and use_flash_attention(cfg, segments, None)):
        return
    tokens = batch["tokens"]
    with torch.no_grad():
        _flash_blocks(cfg, tokens.shape[1], tokens.shape[0], dtype, segments is not None,
                      resolve_flash_grid(cfg, segments), tokens.device)


# ------------------------------------------------------------------------------
# Blockwise SDPA (GQA layout)
# ------------------------------------------------------------------------------


def _block_sdpa(q, k, v, q_pos, k_pos, q_seg, k_seg, k_limit, causal: bool, scale: float,
                q_block: int = 256):
    """q (B, Sq, K, G, dh) over k/v (B, Sk, K, dh), one query block at a time
    so scores never exceed (block × Sk).  Rows with no visible key get the
    uniform average (softmax over equal NEG_INF scores), as in the JAX path."""
    b, sq, kh, g, dh = q.shape
    blk = _pick_block(sq, q_block)
    outs = []
    for start in range(0, sq, blk):
        sl = slice(start, start + blk)
        qi = q[:, sl]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qi, k).float() * scale
        allowed = _block_mask(
            q_pos[:, sl], k_pos, None if q_seg is None else q_seg[:, sl], k_seg, k_limit, causal
        )
        scores = torch.where(allowed[:, None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", probs, v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ------------------------------------------------------------------------------
# GQA forward (slot-scatter prefill / per-slot decode)
# ------------------------------------------------------------------------------


def gqa_attention(
    params: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    positions: torch.Tensor,  # (B, S)
    segments: torch.Tensor | None = None,
    cache: KVCache | None = None,
    cache_index: torch.Tensor | None = None,  # (B,): tokens cached per slot
    dest_slot: torch.Tensor | None = None,  # (B, S): packed→slot scatter map
) -> tuple[torch.Tensor, KVCache | None]:
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kv, dh)
    v = (x @ params["wv"]).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None or dest_slot is not None:
        if cache is not None:
            # Slot-scatter prefill: attention is the cache-free packed-segment
            # path, while the roped K/V stream lands in per-request cache rows
            # at (dest_slot, within-segment position).  Padding positions carry
            # an out-of-range dest row; their writes are dropped.
            num_slots, max_len = cache.k.shape[:2]
            keep = (dest_slot < num_slots) & (positions < max_len)
            rows, cols = dest_slot[keep].long(), positions[keep].long()
            cache.k[rows, cols] = k[keep].to(cache.k.dtype)
            cache.v[rows, cols] = v[keep].to(cache.v.dtype)
        if use_flash_attention(cfg, segments, None):
            # The kernels' row-absolute causal mask plus the segment compare
            # realizes the blockwise path's within-segment objective.
            from repro_torch.kernels.ops import flash_attention

            grid = resolve_flash_grid(cfg, segments)
            bq, bkv = _flash_blocks(cfg, s, b, q.dtype, segments is not None, grid, q.device)
            out = flash_attention(q, k, v, segments, cfg.causal, bq, bkv, grid)
        else:
            out = _block_sdpa(
                q.reshape(b, s, kv, g, dh), k, v, positions, positions,
                segments, segments, None, cfg.causal, 1.0 / (dh**0.5),
            )
        return out.reshape(b, s, h * dh) @ params["wo"], cache

    if cache_index is None or cache_index.dim() != 1 or s != 1:
        raise NotImplementedError(
            "ported paths: cache-free attention, slot-scatter prefill and "
            "one-token per-slot decode"
        )
    # Per-slot cache frontier (continuous-batching decode): row i writes its
    # new K/V at its own offset cache_index[i] and reads keys strictly below
    # its frontier.  A free slot's stale frontier may equal max_len; its
    # write is dropped: with one token per distinct row, the clamped
    # index_put writes the old value back there, with no host sync.
    max_len = cache.k.shape[1]
    rows = torch.arange(b, device=x.device)[:, None]
    cols = cache_index.long()[:, None] + torch.arange(s, device=x.device)[None, :]
    inside = (cols < max_len)[..., None, None]
    cols = cols.clamp(max=max_len - 1)
    cache.k[rows, cols] = torch.where(inside, k.to(cache.k.dtype), cache.k[rows, cols])
    cache.v[rows, cols] = torch.where(inside, v.to(cache.v.dtype), cache.v[rows, cols])
    k_limit = (cache_index.to(positions.dtype)[:, None] + s)[:, :, None]
    k_pos = torch.arange(max_len, dtype=positions.dtype, device=x.device).expand(b, max_len)
    out = _block_sdpa(
        q.reshape(b, s, kv, g, dh), cache.k.to(q.dtype), cache.v.to(q.dtype),
        positions, k_pos, None, None, k_limit, cfg.causal, 1.0 / (dh**0.5),
    )
    return out.reshape(b, s, h * dh) @ params["wo"], cache


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
