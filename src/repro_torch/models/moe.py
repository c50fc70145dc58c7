"""Mixture-of-Experts FFN on one device: router, capacity dispatch, the
batched expert products, the weighted combine, the shared expert and the
dense residual MLP.

The JAX package's single-device branch (``mesh is None``), token for token:

  * Router: fp32 softmax over the experts, top-k, renormalised (floor 1e-9).
    Ties go to the lower expert id, as ``lax.top_k`` breaks them.
  * Dispatch: the slot of a (token, choice) pair within its expert is a
    cumulative sum over the token-major flattened (T·k) one-hot, with a trash
    bucket for experts out of range; pairs past the capacity are dropped
    (GShard semantics).  Every token is routed and counts toward capacity,
    padding of a packed prefill and free decode slots included, as in JAX.
  * Experts: batched products ``(E, C, d) × (E, d, ff)``.
  * Combine: each token's k gathered outputs, weighted, summed over k in a
    fixed order.  Kept pairs own distinct buffer cells, so the dispatch is a
    plain index write and the combine a sum over a (T, k, d) gather: no
    atomic add anywhere, and two runs on the card are bitwise equal.

Expert parallelism (the JAX package's ``shard_map`` over the model axis)
and ``dispatch_chunks`` wait for the port's mesh.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers import act_fn, dense_init

Params = dict[str, Any]


def make_moe_params(generator, cfg, dtype, device) -> Params:
    """fp32 router; the expert slabs are one draw repeated over the
    experts, as the JAX package initialises them."""
    e, d = cfg.n_experts, cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff

    def slab(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype, device)[None].repeat(e, 1, 1)

    p: Params = {
        "router": dense_init(generator, d, e, torch.float32, device),
        "w_in": slab(d, ff),
        "w_gate": slab(d, ff),
        "w_out": slab(ff, d),
    }
    if cfg.n_shared_experts:
        width = ff * cfg.n_shared_experts
        p["shared"] = {
            "w_in": dense_init(generator, d, width, dtype, device),
            "w_gate": dense_init(generator, d, width, dtype, device),
            "w_out": dense_init(generator, width, d, dtype, device),
        }
    return p


def router_topk(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(T, d) -> (T, k) fp32 weights and int64 ids, in descending weight
    with the lower id first among equal weights."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids


def moe_capacity(tokens_local: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(tokens_local * top_k / max(n_experts, 1) * factor)
    return max((cap + 7) // 8 * 8, 8)


def _expert_ffn(buf, w_in, w_gate, w_out, act: str) -> torch.Tensor:
    """(E, C, d) x (E, d, ff) -> (E, C, d): the batched gated expert MLP."""
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    return torch.bmm(act_fn(act)(g) * h, w_out)


def dispatch_slots(ids: torch.Tensor, n_local: int, capacity: int):
    """(T, k) expert ids -> per (token, choice) pair, flattened token-major:
    the destination expert (``n_local`` = the trash bucket), the slot within
    it, and whether the pair is kept (its expert is local and has room)."""
    local = ids.reshape(-1)
    in_range = (local >= 0) & (local < n_local)
    safe_local = torch.where(in_range, local, n_local)
    onehot = torch.nn.functional.one_hot(safe_local, n_local + 1)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=1)
    keep = in_range & (slot < capacity)
    dest_e = torch.where(keep, safe_local, n_local)
    dest_c = torch.where(keep, slot, 0)
    return dest_e, dest_c, keep


def dispatch_compute_combine(
    x_flat: torch.Tensor,  # (T, d) tokens
    weights: torch.Tensor,  # (T, k) fp32
    ids: torch.Tensor,  # (T, k) expert ids
    w_in: torch.Tensor,  # (E, d, ff) expert slab
    w_gate: torch.Tensor,
    w_out: torch.Tensor,  # (E, ff, d)
    *,
    capacity: int,
    act: str,
) -> torch.Tensor:
    """Scatter into capacity buffers → batched expert products → weighted
    combine; (T, d) in the tokens' dtype.  Experts outside ``[0, E)``
    contribute zero."""
    t, k = ids.shape
    n_local, d = w_in.shape[0], x_flat.shape[-1]
    dest_e, dest_c, keep = dispatch_slots(ids, n_local, capacity)
    # Kept pairs own distinct (expert, slot) cells; every dropped pair writes
    # a zero into the trash cell (n_local, 0), which no expert reads.
    rows = x_flat[:, None, :].expand(t, k, d).reshape(t * k, d)
    rows = rows * keep[:, None].to(x_flat.dtype)
    buf = x_flat.new_zeros((n_local + 1, capacity, d)).index_put((dest_e, dest_c), rows)
    out_buf = _expert_ffn(buf[:n_local], w_in, w_gate, w_out, act)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, capacity, d))], dim=0)
    gathered = out_buf[dest_e, dest_c]  # (T*k, d)
    w = (weights.reshape(-1) * keep).to(gathered.dtype)
    return (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)


def _dense_mlp(x_flat: torch.Tensor, p: Params, act: str) -> torch.Tensor:
    """The shared expert / the dense residual MLP (always gated)."""
    h = x_flat @ p["w_in"]
    g = x_flat @ p["w_gate"]
    return (act_fn(act)(g) * h) @ p["w_out"]


def moe_ffn(params: Params, x: torch.Tensor, cfg, dense_params: Params | None = None) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): routed experts, plus the shared expert when the
    tree has one and the dense residual branch (Arctic) when given."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    weights, ids = router_topk(x_flat, params["router"], cfg.top_k)
    cap = moe_capacity(x_flat.shape[0], cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    y = dispatch_compute_combine(
        x_flat, weights, ids, params["w_in"], params["w_gate"], params["w_out"],
        capacity=cap, act=cfg.act,
    )
    if "shared" in params:
        y = y + _dense_mlp(x_flat, params["shared"], cfg.act)
    if dense_params is not None:
        y = y + _dense_mlp(x_flat, dense_params, cfg.act)
    return y.reshape(b, s, d).to(x.dtype)
