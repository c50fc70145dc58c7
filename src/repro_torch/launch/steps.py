"""Step functions (train / prefill / decode) with their mesh placements,
and the serving steps of the continuous-batching engine.

``build_train_step``, ``build_prefill_step`` and ``build_decode_step``
return ``(fn, abstract_args, placements)``: the eager step, meta stand-ins
for its arguments (state, batch, caches, ``cache_index``), and the DTensor
placements the sharding rules give each of them on ``mesh``.  The
stand-ins are meta tensors, the weights too when the model lies on the meta
device (``LM(cfg, device="meta")``); the dry run runs ``fn`` on the stand-ins
of one shard's rows and counts it.

The JAX package jits the serving steps and counts traces (compile-once
contract).  Here they run eagerly, and each carries a :class:`StepCensus`
that counts the distinct input shapes it was called with, so "decode ran at
1 shape" keeps the meaning the JAX launcher's "decode traced 1x" has.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch import sharding as shr
from repro_torch.launch.shapes import (
    ServeCell,
    ShapeCell,
    decode_token_specs,
    prefill_token_specs,
    train_batch_specs,
)
from repro_torch.models.model import LM
from repro_torch.models.ssm import SSMCache
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainer import make_train_step, resolve_attn_impl


def _route_cell_model(model: LM, cell: ShapeCell) -> LM:
    """Pin the cell's preferred attention route.

    A cell with ``attn_impl="flash"`` (the packed train cell) takes the
    flash kernels on a CUDA device; on a device that runs no kernel (the
    CPU, meta) the resolution takes the plain blockwise path, as the JAX
    CPU dry run resolves flash to its XLA path.  A route already pinned on
    the model's config wins.  Returns a model without weights."""
    cfg = model.cfg
    if cell.kind != "train":
        return model
    pins = {}
    if cfg.attn_impl == "auto":
        packed = cell.layout == "packed" or cell.attn_impl == "flash"
        pins["attn_impl"] = resolve_attn_impl(cfg, packed=packed, device=model.device)
    # The cell's grid preference pins an unset attn_grid; kernels/ops still
    # degrades it to dense when segments are absent.
    if cfg.attn_grid == "auto" and cell.attn_grid != "auto":
        pins["attn_grid"] = cell.attn_grid
    if not pins:
        return model
    return LM(dataclasses.replace(cfg, **pins), device=model.device)


def abstract_train_state(model: LM, opt_cfg: OptimizerConfig) -> dict:
    """Weights from ``model.init`` and the optimizer state: meta tensors
    when the model lies on the meta device."""
    params = model.init()
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def train_state_specs(state_shapes, model: LM, mesh) -> dict:
    pspecs = shr.param_specs(state_shapes["params"], model.cfg, mesh)
    return {"params": pspecs, "opt": shr.opt_state_specs(state_shapes["opt"], pspecs)}


def build_train_step(model: LM, mesh, cell: ShapeCell, opt_cfg=None):
    opt_cfg = opt_cfg or OptimizerConfig()
    model = _route_cell_model(model, cell)
    state_shapes = abstract_train_state(model, opt_cfg)
    batch_shapes = train_batch_specs(model.cfg, cell)
    state_specs = train_state_specs(state_shapes, model, mesh)
    placements = (shr.placements(state_specs, mesh),
                  shr.placements(shr.batch_specs(batch_shapes, mesh), mesh))
    return make_train_step(model, opt_cfg), (state_shapes, batch_shapes), placements


# -----------------------------------------------------------------------------
# Serve: prefill / decode
# -----------------------------------------------------------------------------


def abstract_caches(model: LM, batch: int, max_len: int) -> list:
    """``model.init_caches`` with every SSM field allocated (a fresh SSM
    cache holds None, read as zeros), in the JAX package's shapes and the
    model dtype: the caches a decode step reads and writes."""
    cfg = model.cfg
    conv_ch = cfg.d_inner + 2 * cfg.d_state
    out = []
    for cache in model.init_caches(batch, max_len):
        if isinstance(cache, SSMCache):
            cache = SSMCache(
                state=torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.d_state),
                                  dtype=model.dtype, device=model.device),
                conv=torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=model.dtype,
                                 device=model.device),
            )
        out.append(cache)
    return out


def build_prefill_step(model: LM, mesh, cell: ShapeCell, max_len: int | None = None):
    max_len = max_len or cell.seq_len
    params_shapes = model.init()
    tokens_shape = prefill_token_specs(model.cfg, cell)
    pspecs = shr.param_specs(params_shapes, model.cfg, mesh)
    tspec = shr.batch_specs(tokens_shape, mesh)

    @torch.no_grad()
    def prefill(params, tokens):
        if model.cfg.input_embeds:
            # encoder "prefill" = full encode; logits for every frame
            logits = model.forward(params, {"embeds": tokens})
            return logits[:, -1:], None
        return model.prefill(params, tokens, max_len)

    placements = (shr.placements(pspecs, mesh), shr.placements(tspec, mesh))
    return prefill, (params_shapes, tokens_shape), placements


def build_decode_step(model: LM, mesh, cell: ShapeCell, max_len: int | None = None):
    """One-token serve step against a cache of ``cell.seq_len`` tokens."""
    max_len = max_len or cell.seq_len
    params_shapes = model.init()
    cache_shapes = abstract_caches(model, cell.global_batch, max_len)
    tokens_shape = decode_token_specs(cell)
    index_shape = torch.zeros((), dtype=torch.int32, device="meta")

    pspecs = shr.param_specs(params_shapes, model.cfg, mesh)
    cspecs = shr.cache_specs(cache_shapes, model.cfg, mesh)
    tspec = shr.batch_specs(tokens_shape, mesh)

    @torch.no_grad()
    def decode(params, caches, tokens, cache_index):
        return model.decode_step(params, caches, tokens, cache_index)

    args = (params_shapes, cache_shapes, tokens_shape, index_shape)
    placements = (shr.placements(pspecs, mesh), shr.placements(cspecs, mesh),
                  shr.placements(tspec, mesh), shr.placements((), mesh))
    return decode, args, placements


# -----------------------------------------------------------------------------
# Serve: continuous batching (slot cache)
# -----------------------------------------------------------------------------


class StepCensus:
    """Distinct input shapes one step function was called with."""

    def __init__(self) -> None:
        self.shapes: set[tuple] = set()

    def record(self, *tensors: torch.Tensor) -> None:
        self.shapes.add(tuple(tuple(t.shape) for t in tensors))

    @property
    def count(self) -> int:
        """Distinct shapes seen (the JAX step's trace count)."""
        return len(self.shapes)


def build_serve_decode_step(model: LM, cell: ServeCell):
    """Slot decode: ``(num_slots, 1)`` tokens against per-slot frontiers.

    Returns ``(fn, census)``.  Argmax over the real vocabulary runs on the
    device, so only ``(num_slots, 1)`` token ids travel back per tick.
    """
    census = StepCensus()
    vocab = model.cfg.vocab_size

    def decode(params, caches, tokens, lengths):
        if tokens.shape != (cell.num_slots, 1):
            raise ValueError(f"decode tokens {tuple(tokens.shape)} != ({cell.num_slots}, 1)")
        census.record(tokens, lengths)
        with torch.no_grad():
            logits, caches = model.decode_step_slots(params, caches, tokens, lengths)
            nxt = logits[:, :, :vocab].argmax(dim=-1).to(torch.int32)
        return nxt, caches

    return decode, census


def build_serve_prefill_step(model: LM, cell: ServeCell, rows: int, cap: int):
    """Packed scatter prefill for one ``(rows, cap)`` stream bucket.

    The cohort shares one segment-masked stream, K/V scatters into the
    cohort's cache slots, and the per-segment last-position logits are
    gathered *by slot*, so the caller reads one ``(num_slots, vocab)`` row
    per admitted request however the cohort was packed.  Returns
    ``(fn, census)``.
    """
    census = StepCensus()
    vocab = model.cfg.vocab_size

    def prefill(params, caches, tokens, positions, segments, dest_slot, gather_rows, gather_cols):
        if tokens.shape != (rows, cap) or gather_rows.shape != (cell.num_slots,):
            raise ValueError(f"prefill stream {tuple(tokens.shape)} != bucket ({rows}, {cap})")
        census.record(tokens, gather_rows)
        with torch.no_grad():
            logits, caches = model.prefill_packed(
                params, caches, tokens, positions, segments, dest_slot
            )
            picked = logits[gather_rows.long(), gather_cols.long(), :vocab]
        return picked, caches

    return prefill, census
