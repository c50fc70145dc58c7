"""The language model: embeddings + layer stack + head, training and serving
entry points.

``LM`` is an ``nn.Module`` that holds the weights; its step methods take the
parameter tree explicitly, as the JAX package's do, so the trainer, the
engine and the tests can hand it weights from :meth:`LM.init`,
:meth:`LM.load_params` or the JAX bridge alike.  The tree is::

    {"embed": (Vp, d), "unembed": (d, Vp), "final_norm": {"scale"},
     "layers": [{"norm_mixer", "mixer", "norm_ffn", "mlp"}, ...]}

with every projection stored ``(d_in, d_out)`` and applied as ``x @ W``, the
JAX package's layout.  ``layers`` holds every layer in order, DeepSeek-V3's
dense prefix and each of Jamba's hybrid periods included (the JAX tree's
``prefix`` and ``stack`` are the bridge's business).  A non-parametric norm
(OLMo) is an empty group; an MoE layer holds ``moe`` (``router``, the
``(E, d, ff)`` expert slabs and, with a shared expert, a ``shared`` group)
beside its dense residual ``mlp`` (Arctic); an MLA mixer holds the latent
projections and norms (``w_dq``, ``q_norm``, ``w_uq``, ``w_dkv``,
``kv_norm``, ``w_uk``, ``w_uv``, ``wo``); a model fed input embeddings
(HuBERT) has no ``embed``.  Every weight is a trainable ``nn.Parameter``;
the serving steps run under ``torch.no_grad()``, so they record no graph.

Entry points: ``forward`` → fp32 logits and ``loss_sums`` → (loss_sum,
token_count) for training; ``init_caches``, ``prefill_packed`` and
``decode_step_slots`` for the continuous-batching engine; ``prefill`` and
``decode_step`` (one frontier for the whole batch) for per-request serving,
the path of the stacks the engine does not serve (SSM, hybrid, MLA).
Batches are dicts: ``tokens`` (B, S) or, for a model fed input embeddings, ``embeds``
(B, S, d); ``labels``, ``loss_mask`` and, for the packed layout,
``positions`` and ``segments``.  An encoder has no decode: the serving
entry points refuse it, as the JAX package has none.  The layer tree of the
SSM family is ``{"norm_mixer", "mixer"}``: a Mamba-2 mixer and no FFN.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    init_layer_cache,
    layer_forward,
    make_layer_params,
    stack_plan,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import ep_widths, model_axis
from repro_torch.models.layers import (
    apply_norm,
    dense_init,
    make_norm_params,
    masked_cross_entropy,
)

Params = dict[str, Any]

VOCAB_ALIGN = 256  # the JAX package pads the vocab so TP=16 divides it
REMAT_MODES = ("none", "full", "dots")

_aten = torch.ops.aten
_PRODUCTS = (_aten.mm.default, _aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: JAX's ``dots_with_no_batch_dims_saveable``.  Keep
    the output of every matrix product without a batch dimension (``mm``,
    ``addmm``, and a ``bmm`` over a batch of one, which is how ``matmul``
    may fold ``x @ W``) and recompute the rest: the attention scores, the
    MoE's expert slabs and the SSD's contractions are batched products in
    JAX too.  The hand-written kernels are invisible to the dispatcher, so
    they are recomputed, as JAX recomputes a ``pallas_call``."""
    if op in _PRODUCTS or (op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _own_leaves(tree):
    """``tree`` with every view replaced by a copy of its own, so a cut
    leaf does not keep the full tensor it was cut from alive."""
    if isinstance(tree, dict):
        return {k: _own_leaves(v) for k, v in tree.items()}
    return tree.clone() if tree._is_view() else tree


def padded_vocab(vocab: int) -> int:
    return (vocab + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN


class _Group(nn.Module):
    """One group of the parameter tree: its tensors become parameters and its
    dicts nested groups, in the tree's key order; an empty dict is an empty
    group."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        self.keys = tuple(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _Group(value))
            else:
                self.register_parameter(key, nn.Parameter(value))

    def tree(self) -> dict:
        return {key: self._modules[key].tree() if key in self._modules else self._parameters[key]
                for key in self.keys}


class LM(nn.Module):
    """Decoder LM on one device: CUDA unless ``device="cpu"`` is asked for.

    ``mesh`` (a ``DeviceMesh`` with a ``model`` axis, as the JAX ``LM``
    takes one) runs every MoE layer with expert parallelism over that axis
    (``models/moe.py``): the weights are then this rank's tree
    (``launch.sharding.local_moe_params``; :meth:`init` cuts it), and every
    rank of a ``model`` group runs the same rows through the rest of the
    model, replicated.  The JAX package's other use of the mesh, the
    sequence-parallel constraint on the residual stream (``_sp_constraint``)
    and the attention's head constraint, are GSPMD placements with no
    effect on an eager program, so here they are no-ops.
    ``dispatch_chunks`` is the MoE's (the EP branch's token chunks; the JAX
    ``LM`` always passes 1)."""

    def __init__(self, cfg: ArchConfig, device=None, mesh=None, dispatch_chunks: int = 1) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dispatch_chunks = dispatch_chunks
        if cfg.n_experts and (axis := model_axis(mesh)) is not None:
            ep_widths(cfg, axis[1])  # raises unless the model axis divides every width
        self.dtype = getattr(torch, cfg.dtype)
        self.plan = stack_plan(cfg)
        if cfg.attn_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"attn_impl {cfg.attn_impl!r} not in ('xla', 'flash', 'auto')")
        if cfg.attn_grid not in ("dense", "pruned", "auto"):
            raise ValueError(f"attn_grid {cfg.attn_grid!r} not in ('dense', 'pruned', 'auto')")
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"remat {cfg.remat!r} not in {REMAT_MODES}")

    # -- weights ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> Params:
        """Random weights (truncated normal, σ = 1/√d_in; norms at 1) drawn
        from ``generator`` on the model's device; returns the tree."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if generator is None and dev.type != "meta":  # meta draws nothing
            generator = torch.Generator(device=dev).manual_seed(0)
        vp = padded_vocab(cfg.vocab_size)
        params: Params = {"final_norm": make_norm_params(cfg, dt, dev)}
        if not cfg.input_embeds:
            params["embed"] = dense_init(generator, vp, cfg.d_model, dt, dev)
        params["unembed"] = dense_init(generator, cfg.d_model, vp, dt, dev)
        params["layers"] = [make_layer_params(generator, cfg, l, dt, dev)
                            for l in range(cfg.n_layers)]
        if model_axis(self.mesh) is not None:
            from repro_torch.launch.sharding import local_moe_params

            # This rank's cut of the same seeded tree, as leaves of their own.
            local = local_moe_params(params, cfg, self.mesh)
            params = dict(local, layers=[_own_leaves(layer) for layer in local["layers"]])
        return self.load_params(params)

    def load_params(self, params: Params) -> Params:
        """Hold ``params`` (tensors on the model's device) as this module's
        weights; returns the tree view of them."""
        cfg = self.cfg
        vp = padded_vocab(cfg.vocab_size)
        if ("embed" in params) == cfg.input_embeds:
            raise ValueError(f"{cfg.name}: an embed table is {'not ' * cfg.input_embeds}expected "
                             f"(input_embeds={cfg.input_embeds})")
        if "embed" in params and tuple(params["embed"].shape) != (vp, cfg.d_model):
            raise ValueError(f"embed shape {tuple(params['embed'].shape)} != {(vp, cfg.d_model)}")
        if tuple(params["unembed"].shape) != (cfg.d_model, vp):
            raise ValueError(f"unembed shape {tuple(params['unembed'].shape)} != {(cfg.d_model, vp)}")
        if len(params["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers != n_layers {cfg.n_layers}")
        if params["unembed"].device != self.device:
            raise ValueError(f"params on {params['unembed'].device}, model on {self.device}")
        self.embed = None if cfg.input_embeds else nn.Parameter(params["embed"])
        self.unembed = nn.Parameter(params["unembed"])
        self.final_norm = _Group(params["final_norm"])
        self.layers = nn.ModuleList(_Group(layer) for layer in params["layers"])
        return self.params

    @property
    def params(self) -> Params:
        tree: Params = {} if self.embed is None else {"embed": self.embed}
        tree.update(unembed=self.unembed, final_norm=self.final_norm.tree(),
                    layers=[layer.tree() for layer in self.layers])
        return tree

    # -- stack ------------------------------------------------------------------
    def _run_stack(self, params, x, positions, segments, caches, cache_index, dest_slot=None):
        new_caches = []
        for l, (layer_params, cache) in enumerate(zip(params["layers"], caches)):
            x, cache = layer_forward(
                layer_params, x, self.cfg, l, positions, segments, cache, cache_index,
                dest_slot=dest_slot, mesh=self.mesh, dispatch_chunks=self.dispatch_chunks,
            )
            new_caches.append(cache)
        return x, new_caches

    def _train_stack(self, params, x, positions, segments):
        """The cache-free stack.  With ``remat="full"`` (the JAX package's
        ``jax.checkpoint`` around its scan body) each layer keeps only its
        input for the backward and recomputes the rest there; ``"dots"``
        also keeps the products without a batch dimension (:func:`_dots_policy`)."""
        cfg = self.cfg
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        context_fn = _dots_context if cfg.remat == "dots" else noop_context_fn
        for l, layer_params in enumerate(params["layers"]):
            def layer(h, l=l, layer_params=layer_params):
                return layer_forward(layer_params, h, cfg, l, positions, segments, None, None,
                                     mesh=self.mesh, dispatch_chunks=self.dispatch_chunks)[0]

            x = checkpoint(layer, x, use_reentrant=False, context_fn=context_fn) if remat else layer(x)
        return x

    def _logits(self, params, x) -> torch.Tensor:
        x = apply_norm(params["final_norm"], x, self.cfg)
        return (x @ params["unembed"]).float()

    # -- training ---------------------------------------------------------------
    def _embed(self, params: Params, batch: dict) -> torch.Tensor:
        if self.cfg.input_embeds:
            return batch["embeds"].to(self.dtype)
        return params["embed"][batch["tokens"]]

    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        """Logits over the padded vocabulary; the padding columns carry a
        -1e9 bias so they never win a softmax."""
        x = self._embed(params, batch)
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        x = self._train_stack(params, x, positions, batch.get("segments"))
        x = apply_norm(params["final_norm"], x, self.cfg)
        logits = x @ params["unembed"]
        if self.cfg.logits_fp32:
            logits = logits.float()
        vp = padded_vocab(self.cfg.vocab_size)
        if vp != self.cfg.vocab_size:
            pad_bias = torch.where(
                torch.arange(vp, device=logits.device) < self.cfg.vocab_size, 0.0, -1e9
            ).to(logits.dtype)
            logits = logits + pad_bias
        return logits

    def loss_sums(self, params: Params, batch: dict):
        """(loss_sum, token_count) over valid targets — Eq. 2 primitives."""
        logits = self.forward(params, batch)
        return masked_cross_entropy(
            logits, batch["labels"], batch["loss_mask"], fp32=self.cfg.logits_fp32
        )

    # -- serving ------------------------------------------------------------------
    def _require_decode(self) -> None:
        if not self.cfg.has_decode:
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode step")

    def init_caches(self, batch: int, max_len: int) -> list:
        return [
            init_layer_cache(self.cfg, l, batch, max_len, self.dtype, self.device)
            for l in range(self.cfg.n_layers)
        ]

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int):
        """Encode a (B, S) batch of prompts into fresh caches from a zero
        state; returns (last-token fp32 logits (B, 1, Vp), caches).

        GQA layers take the slot-scatter path with one segment per row and
        row i's K/V landing in cache row i; MLA layers fill their latent
        cache from index 0 and attend in the direct form; SSM layers run the
        chunked SSD from a zero state and keep its final state."""
        self._require_decode()
        cfg = self.cfg
        b, s = tokens.shape
        caches = self.init_caches(b, max_len)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        segments = torch.ones((b, s), dtype=torch.int32, device=tokens.device)
        dest_slot = torch.arange(b, dtype=torch.int32, device=tokens.device)[:, None].expand(b, s)
        x = params["embed"][tokens]
        for l, layer_params in enumerate(params["layers"]):
            scatter = cfg.layer_kind(l) == "attn" and cfg.attn_kind == "gqa"
            x, caches[l] = layer_forward(
                layer_params, x, cfg, l, positions, segments if scatter else None, caches[l], 0,
                dest_slot=dest_slot if scatter else None, mesh=self.mesh,
                dispatch_chunks=self.dispatch_chunks,
            )
        return self._logits(params, x[:, -1:]), caches

    def prefill_packed(
        self,
        params: Params,
        caches: list,
        tokens: torch.Tensor,  # (R, S) packed-segment stream
        positions: torch.Tensor,  # (R, S) within-segment positions
        segments: torch.Tensor,  # (R, S) 0 = padding, >=1 per request
        dest_slot: torch.Tensor,  # (R, S) cache row per stream position
    ):
        """Packed-segment prefill scattering K/V into per-request cache slots.

        Several admitted prompts share one packed stream; each layer's roped
        K/V lands in the cache row named by ``dest_slot`` at its
        within-segment position (padding points out of range and is
        dropped).  Returns the full-stream fp32 logits and the caches.
        """
        self._require_decode()
        x = params["embed"][tokens]
        x, caches = self._run_stack(
            params, x, positions, segments, caches, None, dest_slot=dest_slot
        )
        return self._logits(params, x), caches

    def decode_step_slots(
        self,
        params: Params,
        caches: list,
        tokens: torch.Tensor,  # (B, 1) — one pending token per cache slot
        lengths: torch.Tensor,  # (B,) int32: per-slot tokens already cached
    ):
        """One decode step against per-slot cache frontiers: every slot sits
        at its own depth ``lengths[i]``, so admission and eviction never
        change the step's shape."""
        self._require_decode()
        s = tokens.shape[1]
        x = params["embed"][tokens]
        positions = lengths.to(torch.int32)[:, None] + torch.arange(
            s, dtype=torch.int32, device=tokens.device
        )
        x, caches = self._run_stack(params, x, positions, None, caches, lengths)
        return self._logits(params, x), caches

    @torch.no_grad()
    def decode_step(
        self,
        params: Params,
        caches: list,
        tokens: torch.Tensor,  # (B, 1)
        cache_index,  # scalar (int or 0-d tensor): tokens already cached in every row
    ):
        """One decode step with one frontier for the whole batch: the
        per-slot step with ``cache_index`` broadcast to every row."""
        lengths = torch.as_tensor(cache_index, dtype=torch.int32, device=tokens.device)
        if lengths.dim() != 0:
            raise ValueError(f"cache_index must be a scalar, got shape {tuple(lengths.shape)}")
        return self.decode_step_slots(params, caches, tokens, lengths.expand(tokens.shape[0]))


def shift_labels(
    tokens: torch.Tensor,
    loss_mask: torch.Tensor,
    pad_id: int = 0,
    segments: torch.Tensor | None = None,
):
    """Next-token targets: labels[t] = tokens[t+1]; last position masked.

    With ``segments`` (packed layout) a position is also masked when the next
    token belongs to another segment, or the last token of each packed sample
    would be trained to predict its row neighbour's first token.
    """
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], pad_id)], dim=1)
    mask = loss_mask * torch.cat([loss_mask[:, 1:], torch.zeros_like(loss_mask[:, :1])], dim=1)
    if segments is not None:
        next_seg = torch.cat([segments[:, 1:], torch.zeros_like(segments[:, :1])], dim=1)
        mask = mask * (segments == next_seg).to(mask.dtype)
    return labels, mask
