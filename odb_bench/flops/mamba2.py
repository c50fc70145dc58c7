"""Mamba-2 (SSD) training FLOPs.

Per real token, 6 FLOPs per weight of the in- and out-projections and the
untied output head; the depthwise causal conv (2·d_conv per channel); and
the SSD's chunked work (``bounds.ssd_work``'s count over the sample's own
chunks: C·Bᵀ and W·x over the causal pairs inside each chunk, C·state and
the state update per token), three times over for forward and backward.
"""

from __future__ import annotations


def _dims(sizes: dict):
    a = sizes["assumed"]
    d = sizes["d_model"]
    di = a["expand"] * d
    return d, di, a["d_state"], a["headdim"], di // a["headdim"], a["chunk_size"], a["d_conv"]


def ssd_flops(sizes: dict, length: int) -> float:
    """Forward FLOPs of one layer's SSD over one sample of ``length``."""
    _, _, n, p, h, q, _ = _dims(sizes)
    full, rest = divmod(length, q)
    pairs = full * q * (q + 1) // 2 + rest * (rest + 1) // 2
    return 2.0 * (pairs * n + h * (pairs * p + 2 * length * p * n))


def train_flops(sizes: dict, lengths) -> float:
    d, di, n, _, h, _, k = _dims(sizes)
    proj = d * (2 * di + 2 * n + h) + di * d
    conv = 2 * k * (di + 2 * n)
    tokens = sum(lengths)
    layers = sizes["n_layer"]
    per_token = 6.0 * (layers * proj + d * sizes["vocab_size"]) + 3.0 * layers * conv
    return per_token * tokens + 3.0 * layers * sum(ssd_flops(sizes, n_) for n_ in lengths)
