"""Serving step functions: slot decode and packed scatter prefill.

The JAX package jits these and counts traces (compile-once contract).  Here
the steps run eagerly, and each carries a :class:`StepCensus` that counts
the distinct input shapes it was called with, so "decode ran at 1 shape" keeps
the meaning the JAX launcher's "decode traced 1x" has.
"""

from __future__ import annotations

import torch

from repro_torch.launch.shapes import ServeCell
from repro_torch.models.model import LM


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
