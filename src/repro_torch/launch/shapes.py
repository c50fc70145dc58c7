"""Input-shape cells and their applicability rules (the JAX package's
``launch/shapes.py``).

LM transformer shapes are seq_len x global_batch; ``decode_*`` / ``long_*``
run the serve step (one new token against a filled KV cache), not the train
step; ``prefill_*`` runs the prompt-encoding serve path.  The stand-ins for
a cell's inputs are meta tensors of the JAX stand-ins' shapes and dtypes.
"""

from __future__ import annotations

import dataclasses

import torch


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    layout: str = "dense"  # batch layout of train cells
    # Preferred attention route for this cell.  "flash" is a preference, not
    # a pin: launch/steps resolves it against the device, so a dry run on
    # the meta device takes the plain blockwise path.
    attn_impl: str = "auto"
    # Preferred flash grid variant: "pruned" walks only the live kv tiles of
    # packed cells; consulted only when the cell takes the flash route.
    attn_grid: str = "auto"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    # Packed layout: the same 4k row capacity, fewer rows (each row carries
    # ~row_capacity real tokens instead of one right-padded sample).
    "train_4k_packed": ShapeCell(
        "train_4k_packed", 4096, 64, "train", layout="packed",
        attn_impl="flash", attn_grid="pruned",
    ),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "train_4k_packed", "prefill_32k", "decode_32k", "long_500k")


def applicability(cfg, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason)."""
    cell = SHAPES[shape_name]
    if cell.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; skipped for pure "
            "full-attention archs (DESIGN.md §4)"
        )
    return True, ""


def train_batch_specs(cfg, cell: ShapeCell) -> dict:
    """Meta stand-ins for one global training batch.  The packed layout
    also threads within-segment positions and segment ids to the model, as
    ``assemble_model_batch`` does at train time."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.input_embeds:
        return {
            "embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
            "labels": _meta((b, s), torch.int32),
            "loss_mask": _meta((b, s), torch.float32),
        }
    specs = {
        "tokens": _meta((b, s), torch.int32),
        "labels": _meta((b, s), torch.int32),
        "loss_mask": _meta((b, s), torch.float32),
    }
    if cell.layout == "packed":
        specs["positions"] = _meta((b, s), torch.int32)
        specs["segments"] = _meta((b, s), torch.int32)
    return specs


# -----------------------------------------------------------------------------
# Serving cells (continuous batching)
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """Shape contract of one continuous-batching serve deployment.

    ``num_slots`` fixes the decode batch rows (= KV-cache slots); ``max_len``
    the per-slot cache capacity; ``l_max`` the shared admission token budget
    (the Eq.-1 knob reused from training).  The packed prefill stream is
    bucketed separately (``PackedBucketSpec`` grid in the engine config), so
    the step census is: exactly one decode shape + one prefill shape per
    occupied (rows, capacity) bucket.
    """

    name: str
    num_slots: int
    max_len: int
    l_max: int


SERVE_SHAPES = {
    "serve_smoke": ServeCell("serve_smoke", 8, 256, 1024),
    "serve_32k": ServeCell("serve_32k", 128, 32768, 1 << 22),
}


def serve_decode_specs(cell: ServeCell) -> tuple:
    """(tokens, lengths) stand-ins for the slot decode step."""
    return (_meta((cell.num_slots, 1), torch.int32), _meta((cell.num_slots,), torch.int32))


def serve_prefill_specs(rows: int, cap: int, num_slots: int) -> tuple:
    """(tokens, positions, segments, dest_slot, gather_rows, gather_cols)
    stand-ins for one packed scatter-prefill bucket."""
    stream = [_meta((rows, cap), torch.int32) for _ in range(4)]
    gather = [_meta((num_slots,), torch.int32) for _ in range(2)]
    return (*stream, *gather)


def prefill_token_specs(cfg, cell: ShapeCell) -> torch.Tensor:
    if cfg.input_embeds:
        return _meta((cell.global_batch, cell.seq_len, cfg.d_model), torch.bfloat16)
    return _meta((cell.global_batch, cell.seq_len), torch.int32)


def decode_token_specs(cell: ShapeCell) -> torch.Tensor:
    return _meta((cell.global_batch, 1), torch.int32)
