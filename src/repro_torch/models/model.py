"""The language model: embeddings + layer stack + head, training and serving
entry points.

``LM`` is an ``nn.Module`` that holds the weights; its step methods take the
parameter tree explicitly, as the JAX package's do, so the trainer, the
engine and the tests can hand it weights from :meth:`LM.init`,
:meth:`LM.load_params` or the JAX bridge alike.  The tree is::

    {"embed": (Vp, d), "unembed": (d, Vp), "final_norm": {"scale"},
     "layers": [{"norm_mixer", "mixer", "norm_ffn", "mlp"}, ...]}

with every projection stored ``(d_in, d_out)`` and applied as ``x @ W``, the
JAX package's layout.  Every weight is a trainable ``nn.Parameter``; the
serving steps run under ``torch.no_grad()``, so they record no graph.

Entry points: ``forward`` → fp32 logits and ``loss_sums`` → (loss_sum,
token_count) for training; ``init_caches``, ``prefill_packed`` and
``decode_step_slots`` for serving.  Batches are dicts: ``tokens`` (B, S),
``labels``, ``loss_mask`` and, for the packed layout, ``positions`` and
``segments``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    init_layer_cache,
    layer_forward,
    make_layer_params,
    stack_plan,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_norm,
    dense_init,
    make_norm_params,
    masked_cross_entropy,
)

Params = dict[str, Any]

VOCAB_ALIGN = 256  # the JAX package pads the vocab so TP=16 divides it


def padded_vocab(vocab: int) -> int:
    return (vocab + VOCAB_ALIGN - 1) // VOCAB_ALIGN * VOCAB_ALIGN


def _parameters(group: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in group.items()})


class LM(nn.Module):
    """Decoder LM on one device: CUDA unless ``device="cpu"`` is asked for."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.plan = stack_plan(cfg)
        if cfg.attn_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"attn_impl {cfg.attn_impl!r} not in ('xla', 'flash', 'auto')")
        if cfg.attn_grid not in ("dense", "pruned", "auto"):
            raise ValueError(f"attn_grid {cfg.attn_grid!r} not in ('dense', 'pruned', 'auto')")
        if cfg.remat == "dots":
            raise NotImplementedError("remat='dots' is not ported yet; use 'full' or 'none'")

    # -- weights ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> Params:
        """Random weights (truncated normal, σ = 1/√d_in; norms at 1) drawn
        from ``generator`` on the model's device; returns the tree."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        vp = padded_vocab(cfg.vocab_size)
        return self.load_params({
            "final_norm": make_norm_params(cfg, dt, dev),
            "embed": dense_init(generator, vp, cfg.d_model, dt, dev),
            "unembed": dense_init(generator, cfg.d_model, vp, dt, dev),
            "layers": [make_layer_params(generator, cfg, dt, dev) for _ in range(cfg.n_layers)],
        })

    def load_params(self, params: Params) -> Params:
        """Hold ``params`` (tensors on the model's device) as this module's
        weights; returns the tree view of them."""
        vp = padded_vocab(self.cfg.vocab_size)
        if tuple(params["embed"].shape) != (vp, self.cfg.d_model):
            raise ValueError(f"embed shape {tuple(params['embed'].shape)} != {(vp, self.cfg.d_model)}")
        if len(params["layers"]) != self.cfg.n_layers:
            raise ValueError(f"{len(params['layers'])} layers != n_layers {self.cfg.n_layers}")
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, model on {self.device}")
        self.embed = nn.Parameter(params["embed"])
        self.unembed = nn.Parameter(params["unembed"])
        self.final_norm = _parameters(params["final_norm"])
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: _parameters(group) for name, group in layer.items()})
            for layer in params["layers"]
        )
        return self.params

    @property
    def params(self) -> Params:
        return {
            "embed": self.embed,
            "unembed": self.unembed,
            "final_norm": dict(self.final_norm),
            "layers": [
                {name: dict(group) for name, group in layer.items()} for layer in self.layers
            ],
        }

    # -- stack ------------------------------------------------------------------
    def _run_stack(self, params, x, positions, segments, caches, cache_index, dest_slot=None):
        new_caches = []
        for layer_params, cache in zip(params["layers"], caches):
            x, cache = layer_forward(
                layer_params, x, self.cfg, positions, segments, cache, cache_index,
                dest_slot=dest_slot,
            )
            new_caches.append(cache)
        return x, new_caches

    def _train_stack(self, params, x, positions, segments):
        """The cache-free stack.  With ``remat="full"`` (the JAX package's
        ``jax.checkpoint`` around its scan body) each layer keeps only its
        input for the backward and recomputes the rest there."""
        cfg = self.cfg
        remat = cfg.remat == "full" and torch.is_grad_enabled()
        for layer_params in params["layers"]:
            def layer(h, layer_params=layer_params):
                return layer_forward(layer_params, h, cfg, positions, segments, None, None)[0]

            x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        return x

    def _logits(self, params, x) -> torch.Tensor:
        x = apply_norm(params["final_norm"], x, self.cfg)
        return (x @ params["unembed"]).float()

    # -- training ---------------------------------------------------------------
    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        """Logits over the padded vocabulary; the padding columns carry a
        -1e9 bias so they never win a softmax."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        x = params["embed"][tokens]
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
    def init_caches(self, batch: int, max_len: int) -> list:
        return [
            init_layer_cache(self.cfg, batch, max_len, self.dtype, self.device)
            for _ in range(self.cfg.n_layers)
        ]

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
        s = tokens.shape[1]
        x = params["embed"][tokens]
        positions = lengths.to(torch.int32)[:, None] + torch.arange(
            s, dtype=torch.int32, device=tokens.device
        )
        x, caches = self._run_stack(params, x, positions, None, caches, lengths)
        return self._logits(params, x), caches


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
