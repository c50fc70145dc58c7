"""Layer blocks: pre-norm mixer + FFN with residuals, and the stack plan.

The JAX package scans its stack over units of layers; here the stack is a
Python loop over unstacked layers, each with its own parameters and cache,
and the plan only says how the bridge and the checkpoints stack the layers
in the JAX tree: leading dense layers (DeepSeek-V3's ``first_k_dense``) as
an unrolled prefix, the rest in units of one layer, of ``moe_every`` layers
when MoE skips layers, or of one hybrid period (Jamba: ``attn_period``
layers, one attention and the rest Mamba-2, MoE on every ``moe_every``-th).
A layer's mixer is GQA or MLA attention or a Mamba-2 mixer; its FFN a dense
MLP, an MoE FFN (with an optional dense residual MLP), or none (mamba2).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.attention import apply_attention, init_kv_cache, make_attention_params
from repro_torch.models.layers import apply_mlp, apply_norm, make_mlp_params, make_norm_params
from repro_torch.models.moe import make_moe_params, moe_ffn
from repro_torch.models.ssm import apply_ssm_block, init_ssm_cache, make_ssm_params

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StackPlan:
    prefix_layers: tuple[int, ...]  # leading layers of another kind
    unit_layers: tuple[tuple[int, ...], ...]  # repeated units (layer idx tuples)

    @property
    def n_units(self) -> int:
        return len(self.unit_layers)


def stack_plan(cfg) -> StackPlan:
    """The JAX package's unit structure (the bridge unstacks by it): the
    ``first_k_dense`` prefix, then units of the hybrid period, of
    ``moe_every`` layers, or of one layer; every unit of the same layer
    kinds."""
    prefix = tuple(range(cfg.first_k_dense))
    rest = range(cfg.first_k_dense, cfg.n_layers)
    period = cfg.attn_period if cfg.family == "hybrid" else 1
    if cfg.family != "hybrid" and cfg.n_experts and cfg.moe_every > 1:
        period = cfg.moe_every
    if len(rest) % period:
        raise ValueError(f"{cfg.name}: {len(rest)} layers after the prefix are not whole units "
                         f"of {period}")
    units = tuple(tuple(rest[i:i + period]) for i in range(0, len(rest), period))
    kinds = {tuple((cfg.layer_kind(l), cfg.layer_is_moe(l)) for l in u) for u in units}
    if len(kinds) > 1:
        raise ValueError(f"inhomogeneous units for {cfg.name}: {kinds}")
    return StackPlan(prefix_layers=prefix, unit_layers=units)


def make_layer_params(generator, cfg, layer_idx: int, dtype, device) -> Params:
    p: Params = {"norm_mixer": make_norm_params(cfg, dtype, device)}
    if cfg.layer_kind(layer_idx) == "attn":
        p["mixer"] = make_attention_params(generator, cfg, dtype, device)
    else:
        p["mixer"] = make_ssm_params(generator, cfg, dtype, device)
    if cfg.layer_is_moe(layer_idx):
        p["norm_ffn"] = make_norm_params(cfg, dtype, device)
        p["moe"] = make_moe_params(generator, cfg, dtype, device)
        if cfg.dense_residual:
            p["mlp"] = make_mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device)
    elif cfg.d_ff:
        p["norm_ffn"] = make_norm_params(cfg, dtype, device)
        p["mlp"] = make_mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device)
    return p


def layer_forward(params: Params, x, cfg, layer_idx: int, positions, segments, cache, cache_index,
                  dest_slot=None, mesh=None, dispatch_chunks: int = 1):
    """One layer.  ``mesh`` reaches the MoE, which runs expert parallelism
    over its ``model`` axis (``params`` then holds the rank's MoE shard), and
    the attention, as in the JAX package; ``dispatch_chunks`` is the MoE's."""
    h = apply_norm(params["norm_mixer"], x, cfg)
    if cfg.layer_kind(layer_idx) == "attn":
        mixed, new_cache = apply_attention(
            params["mixer"], h, cfg, positions, segments, cache, cache_index, mesh=mesh,
            dest_slot=dest_slot,
        )
    else:
        if dest_slot is not None:
            raise NotImplementedError(
                "slot-scatter prefill cannot reconstruct per-segment SSM "
                "states from a packed stream; SSM serving uses the "
                "per-request prefill path (LM.prefill / LM.decode_step)"
            )
        mixed, new_cache = apply_ssm_block(params["mixer"], h, cfg, cache)
    x = x + mixed
    if "norm_ffn" not in params:  # FFN-free block (mamba2: SSD mixer only)
        return x, new_cache
    h = apply_norm(params["norm_ffn"], x, cfg)
    if cfg.layer_is_moe(layer_idx):
        dense = params["mlp"] if cfg.dense_residual else None
        ffn = moe_ffn(params["moe"], h, cfg, mesh=mesh, dense_params=dense,
                      dispatch_chunks=dispatch_chunks)
    else:
        ffn = apply_mlp(params["mlp"], h, cfg.act, cfg.gated_mlp)
    return x + ffn, new_cache


def init_layer_cache(cfg, layer_idx: int, batch: int, max_len: int, dtype, device):
    if cfg.layer_kind(layer_idx) == "attn":
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    return init_ssm_cache()
