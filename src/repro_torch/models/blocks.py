"""Layer blocks: pre-norm mixer + FFN with residuals, and the stack plan.

The JAX package scans its stack over units of layers; here the stack is a
Python loop over unstacked layers, each with its own parameters and cache.
Ported: GQA attention with a dense MLP (families ``dense``, ``vlm`` and
``encoder``) or an MoE FFN with an optional dense residual MLP (``moe``,
MoE on every ``moe_every``-th layer), and the SSM family (a Mamba-2 mixer
and no FFN).  Not yet: leading dense layers (``first_k_dense``), the hybrid
period and MLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.attention import gqa_attention, init_kv_cache, make_attention_params
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
    """The JAX package's unit structure (the bridge unstacks by it): one layer
    per unit, or ``moe_every`` layers when MoE skips layers; no prefix."""
    if (cfg.family not in ("dense", "vlm", "encoder", "moe", "ssm") or cfg.first_k_dense
            or cfg.attn_kind == "mla"):
        raise NotImplementedError(f"family {cfg.family!r} of {cfg.name} is not ported yet")
    period = cfg.moe_every if cfg.n_experts and cfg.moe_every > 1 else 1
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole units of {period}")
    layers = range(cfg.n_layers)
    units = tuple(tuple(layers[i:i + period]) for i in range(0, cfg.n_layers, period))
    return StackPlan(prefix_layers=(), unit_layers=units)


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
                  dest_slot=None):
    h = apply_norm(params["norm_mixer"], x, cfg)
    if cfg.layer_kind(layer_idx) == "attn":
        mixed, new_cache = gqa_attention(
            params["mixer"], h, cfg, positions, segments, cache, cache_index, dest_slot=dest_slot
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
        ffn = moe_ffn(params["moe"], h, cfg, dense_params=dense)
    else:
        ffn = apply_mlp(params["mlp"], h, cfg.act, cfg.gated_mlp)
    return x + ffn, new_cache


def init_layer_cache(cfg, layer_idx: int, batch: int, max_len: int, dtype, device):
    if cfg.layer_kind(layer_idx) == "attn":
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    return init_ssm_cache()
