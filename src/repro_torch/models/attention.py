"""Attention: GQA/MQA/MHA and MLA (DeepSeek-V3, DeepSeek-V2-Lite), their caches, segment masking.

GQA has three paths: cache-free attention (training), the slot-scatter
prefill (serving) and the per-slot decode over the cache.  The first two
have two implementations behind one entry point: the plain blockwise masked
attention below (``attn_impl="xla"``, the name kept from the JAX package)
and the hand-written segment flash kernels in ``repro_torch.kernels``, whose
autograd backward is a kernel too.  ``use_flash_attention`` routes between
them from ``ArchConfig.attn_impl``; "auto" takes the kernel exactly when the
batch is packed and the tensors lie on a CUDA device.  Decode always takes
the plain path over the cache.

MLA always takes the plain path, as in the JAX package, which computes it
with XLA einsums and no kernel: training and prefill in the direct form
(the latents expanded to per-head keys and values), decode in the absorbed
form against the latent cache.  Its prefill fills the cache of one request
per row from index 0; it has no slot-scatter map.

Masking contract (shared with the kernels): attention is allowed iff
``segment_ids`` match (padding carries segment 0) AND (causal ⇒ key position
≤ query position).  The kernels mask causally by absolute row; the plain
path by within-segment ``positions``.  The two agree because segments are
contiguous and positions restart at every segment start.

The caches are updated in place (the JAX package returns new arrays): the
cache is the largest state on the card, and a copy per layer per step would
double its traffic.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_rope, dense_init, rms_norm, yarn_frequencies, yarn_mscale

Params = dict[str, Any]

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, n_kv, d_head)
    v: torch.Tensor  # (B, S_max, n_kv, d_head)


class MLACache(NamedTuple):
    ckv: torch.Tensor  # (B, S_max, kv_lora_rank) — the compressed latent
    k_rope: torch.Tensor  # (B, S_max, qk_rope_dim) — the rope key shared by the heads


def make_attention_params(generator, cfg, dtype, device) -> Params:
    if cfg.attn_kind == "mla":
        return _make_mla_params(generator, cfg, dtype, device)
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


def _make_mla_params(generator, cfg, dtype, device) -> Params:
    """The latent projections; without a query latent (``q_lora_rank`` 0)
    one query projection ``w_q`` in place of ``w_dq``, ``q_norm``, ``w_uq``."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        query = {
            "w_dq": dense_init(generator, d, cfg.q_lora_rank, dtype, device),
            "q_norm": torch.ones((cfg.q_lora_rank,), dtype=dtype, device=device),
            "w_uq": dense_init(generator, cfg.q_lora_rank, h * (nope + rope), dtype, device),
        }
    else:
        query = {"w_q": dense_init(generator, d, h * (nope + rope), dtype, device)}
    return {
        **query,
        "w_dkv": dense_init(generator, d, cfg.kv_lora_rank + rope, dtype, device),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=device),
        "w_uk": dense_init(generator, cfg.kv_lora_rank, h * nope, dtype, device),
        "w_uv": dense_init(generator, cfg.kv_lora_rank, h * vdim, dtype, device),
        "wo": dense_init(generator, h * vdim, d, dtype, device),
    }


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
    ``tokens`` or ``embeds`` and, when packed, ``segments``) outside
    autograd, so the forward that follows finds its schedule in the cache.
    A no-op unless ``attn_autotune`` is set and the batch takes the flash
    route."""
    segments = batch.get("segments")
    if not (cfg.attn_autotune and cfg.attn_kind == "gqa"
            and use_flash_attention(cfg, segments, None)):
        return
    inputs = batch["embeds"] if cfg.input_embeds else batch["tokens"]
    with torch.no_grad():
        _flash_blocks(cfg, inputs.shape[1], inputs.shape[0], dtype, segments is not None,
                      resolve_flash_grid(cfg, segments), inputs.device)


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
    # its frontier.
    max_len = cache.k.shape[1]
    _write_at_frontier(cache.k, cache_index, k)
    _write_at_frontier(cache.v, cache_index, v)
    k_limit = (cache_index.to(positions.dtype)[:, None] + s)[:, :, None]
    k_pos = torch.arange(max_len, dtype=positions.dtype, device=x.device).expand(b, max_len)
    out = _block_sdpa(
        q.reshape(b, s, kv, g, dh), cache.k.to(q.dtype), cache.v.to(q.dtype),
        positions, k_pos, None, None, k_limit, cfg.causal, 1.0 / (dh**0.5),
    )
    return out.reshape(b, s, h * dh) @ params["wo"], cache


def _write_at_frontier(buf: torch.Tensor, cache_index: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` (B, s, ...) into ``buf`` (B, S_max, ...) in place, row i
    at columns ``cache_index[i]`` onward.  A free slot's stale frontier may
    equal S_max; its write is dropped: with one token per distinct row, the
    clamped index_put writes the old value back there, with no host sync."""
    b, s = new.shape[:2]
    max_len = buf.shape[1]
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = cache_index.long()[:, None] + torch.arange(s, device=buf.device)[None, :]
    inside = (cols < max_len).reshape(b, s, *([1] * (new.dim() - 2)))
    cols = cols.clamp(max=max_len - 1)
    buf[rows, cols] = torch.where(inside, new.to(buf.dtype), buf[rows, cols])


# ------------------------------------------------------------------------------
# MLA forward
# ------------------------------------------------------------------------------


def _mla_block_sdpa(q_nope, q_rope, k_nope, k_rope, v, q_pos, k_pos, q_seg, k_seg, k_limit,
                    causal: bool, scale: float, q_block: int = 256):
    """q_nope (B, Sq, H, nope) and q_rope (B, Sq, H, rope) over k_nope
    (B, Sk, H, nope), the shared k_rope (B, Sk, rope) and v (B, Sk, H, vdim),
    one query block at a time.  The scores are the nope product plus the
    rope product, in fp32, times ``scale``.  Under grad each block keeps only
    its inputs and recomputes its scores in the backward (the JAX package
    checkpoints its scan body), so the saved scores never exceed one block."""
    b, sq = q_nope.shape[:2]

    def block(qn, qr, qp, qs):
        scores = torch.einsum("bqhd,bshd->bhqs", qn, k_nope).float()
        scores = scores + torch.einsum("bqhd,bsd->bhqs", qr, k_rope).float()
        scores = scores * scale
        allowed = _block_mask(qp, k_pos, qs, k_seg, k_limit, causal)
        scores = torch.where(allowed[:, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhqs,bshd->bqhd", probs, v)

    blk = _pick_block(sq, q_block)
    if blk == sq:
        return block(q_nope, q_rope, q_pos, q_seg)
    outs = []
    for start in range(0, sq, blk):
        sl = slice(start, start + blk)
        args = (q_nope[:, sl], q_rope[:, sl], q_pos[:, sl], None if q_seg is None else q_seg[:, sl])
        outs.append(checkpoint(block, *args, use_reentrant=False) if torch.is_grad_enabled()
                    else block(*args))
    return torch.cat(outs, dim=1)


def mla_rope(x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """RoPE on MLA's rope dims: the rotation of halves, after DeepSeek-V2's
    pairing where ``rope_pairing="pairs"``, and with YaRN's frequencies
    where ``yarn_factor`` > 0.  The published code also scales cos and sin
    by mscale(s, mscale) / mscale(s, mscale_all_dim), which is 1 where the
    two are equal, as DeepSeek-V2 publishes them; so nothing scales them
    here."""
    freqs = yarn_frequencies(x.shape[-1], cfg.rope_theta, cfg.yarn_factor, x.device) if cfg.yarn_factor else None
    return apply_rope(x, positions, cfg.rope_theta, freqs=freqs, pairs=cfg.rope_pairing == "pairs")


def mla_attention(
    params: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    positions: torch.Tensor,  # (B, S)
    segments: torch.Tensor | None = None,
    cache: MLACache | None = None,
    cache_index=None,  # decode: (B,) or scalar; prefill: scalar, the first column to fill
) -> tuple[torch.Tensor, MLACache | None]:
    """Multi-head latent attention.  Queries and keys/values go through
    low-rank latents (``q_norm`` and ``kv_norm`` are RMS norms of the
    latents), or the queries through one projection ``w_q`` where
    ``q_lora_rank`` is 0; the last ``qk_rope_dim`` columns of each head's
    query and of the kv down-projection carry RoPE, the latter as one key
    shared by every head.  Scores are scaled by 1/√(nope + rope), and with
    YaRN by its temperature squared (:func:`mla_rope`)."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = 1.0 / ((nope + rope) ** 0.5)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale = scale * yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2

    if cfg.q_lora_rank:
        cq = rms_norm(x @ params["w_dq"], params["q_norm"])
        q = (cq @ params["w_uq"]).reshape(b, s, h, nope + rope)
    else:
        q = (x @ params["w_q"]).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], mla_rope(q[..., nope:], positions, cfg)
    dkv = x @ params["w_dkv"]
    ckv = rms_norm(dkv[..., :r], params["kv_norm"])
    k_rope = mla_rope(dkv[..., r:][:, :, None, :], positions, cfg)[:, :, 0, :]

    if cache is not None and s == 1:
        # Decode, weight-absorbed: attend in the latent space, so a step costs
        # O(S·(kv_lora + rope)) per head and the cache keeps (kv_lora + rope)
        # per token.  Row i writes at its frontier cache_index[i] and reads
        # the keys below it.
        frontier = torch.as_tensor(cache_index, device=x.device)
        if frontier.dim() == 0:
            frontier = frontier.expand(b)
        _write_at_frontier(cache.ckv, frontier, ckv)
        _write_at_frontier(cache.k_rope, frontier, k_rope)
        max_len = cache.ckv.shape[1]
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"].reshape(r, h, nope))
        scores = torch.einsum("bshr,btr->bhst", q_lat, cache.ckv).float()
        scores = scores + torch.einsum("bshr,btr->bhst", q_rope, cache.k_rope).float()
        scores = scores * scale
        k_pos = torch.arange(max_len, dtype=positions.dtype, device=x.device)[None, None, :]
        allowed = (k_pos <= positions[:, :, None]) & (
            k_pos < (frontier.to(positions.dtype) + s)[:, None, None])
        scores = torch.where(allowed[:, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cache.ckv.dtype)
        out_lat = torch.einsum("bhst,btr->bshr", probs, cache.ckv)
        out = torch.einsum("bshr,rhv->bshv", out_lat, params["w_uv"].reshape(r, h, vdim))
        return out.reshape(b, s, h * vdim) @ params["wo"], cache

    # Train / prefill: the direct form.
    k_nope = (ckv @ params["w_uk"]).reshape(b, s, h, nope)
    v = (ckv @ params["w_uv"]).reshape(b, s, h, vdim)
    if cache is not None:  # prefill fills the latent cache from cache_index on
        start = int(cache_index)
        cache.ckv[:, start:start + s] = ckv.to(cache.ckv.dtype)
        cache.k_rope[:, start:start + s] = k_rope.to(cache.k_rope.dtype)
    out = _mla_block_sdpa(q_nope, q_rope, k_nope, k_rope, v, positions, positions, segments, segments,
                          None, cfg.causal, scale)
    return out.reshape(b, s, h * vdim) @ params["wo"], cache


def apply_attention(params, x, cfg, positions, segments=None, cache=None, cache_index=None,
                    mesh=None, dest_slot=None):
    """The attention mixer of one layer: MLA on its plain path, else GQA.
    ``mesh`` is taken as in the JAX package, where it only places a GSPMD
    constraint on the heads; an eager program has no such placement, so
    here it changes nothing (``launch/perf.py`` records the same)."""
    if cfg.attn_kind == "mla":
        if dest_slot is not None:
            raise NotImplementedError(
                "slot-scatter prefill needs the GQA cache layout; MLA serving "
                "stays on the per-request prefill path (LM.prefill / LM.decode_step)"
            )
        return mla_attention(params, x, cfg, positions, segments, cache, cache_index)
    return gqa_attention(params, x, cfg, positions, segments, cache, cache_index, dest_slot=dest_slot)


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> KVCache | MLACache:
    if cfg.attn_kind == "mla":
        return MLACache(
            ckv=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
            k_rope=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        )
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
