"""Layer blocks: pre-norm mixer + FFN with residuals, and the stack plan.

The JAX package scans its stack over units of layers; here the stack is a
Python loop over unstacked layers, each with its own parameters and cache.
Ported so far: the dense family (GQA attention + gated MLP).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.attention import gqa_attention, init_kv_cache, make_attention_params
from repro_torch.models.layers import apply_mlp, apply_norm, make_mlp_params, make_norm_params

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StackPlan:
    prefix_layers: tuple[int, ...]  # leading layers of another kind
    unit_layers: tuple[tuple[int, ...], ...]  # repeated units (layer idx tuples)

    @property
    def n_units(self) -> int:
        return len(self.unit_layers)


def stack_plan(cfg) -> StackPlan:
    """The JAX package's unit structure; the dense family is one layer per
    unit with no prefix (the bridge unstacks by it)."""
    if cfg.family != "dense" or cfg.n_experts or cfg.first_k_dense:
        raise NotImplementedError(f"family {cfg.family!r} of {cfg.name} is not ported yet")
    return StackPlan(prefix_layers=(), unit_layers=tuple((l,) for l in range(cfg.n_layers)))


def make_layer_params(generator, cfg, dtype, device) -> Params:
    return {
        "norm_mixer": make_norm_params(cfg, dtype, device),
        "mixer": make_attention_params(generator, cfg, dtype, device),
        "norm_ffn": make_norm_params(cfg, dtype, device),
        "mlp": make_mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device),
    }


def layer_forward(params: Params, x, cfg, positions, segments, cache, cache_index, dest_slot=None):
    h = apply_norm(params["norm_mixer"], x, cfg)
    mixed, new_cache = gqa_attention(
        params["mixer"], h, cfg, positions, segments, cache, cache_index, dest_slot=dest_slot
    )
    x = x + mixed
    h = apply_norm(params["norm_ffn"], x, cfg)
    return x + apply_mlp(params["mlp"], h, cfg.act, cfg.gated_mlp), new_cache


def init_layer_cache(cfg, batch: int, max_len: int, dtype, device):
    return init_kv_cache(cfg, batch, max_len, dtype, device)
