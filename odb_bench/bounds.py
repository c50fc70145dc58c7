"""The yardstick: the card's peaks and the least work of each kernel.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W (dense
bf16, no sparsity; HBM3).  A kernel's bound time is the larger of its least
operations over the peak rate and its least bytes over the peak bandwidth,
each input read once and each output written once (the kernel table's
convention).  The arithmetic is a frozen copy of the one the port's chip
smoke test prints beside every kernel time.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def visible_pairs(lengths) -> int:
    """The (query, key) pairs a causal mask within each segment lets through."""
    return sum(n * (n + 1) // 2 for n in lengths)


def flash_work(rows: int, cap: int, heads: int, kv_heads: int, d_head: int, pairs: int) -> dict:
    """(FLOPs, bytes) of the forward (K4), dQ (K5) and dK/dV (K6) passes of
    one bf16 attention call over a (rows, cap) packed batch: 4, 6 and 8·D
    FLOPs per visible pair and query head; q, k, v, out, dout, dq, dk, dv,
    the fp32 row statistics and the segment ids moved once."""
    elem = rows * cap * d_head
    qo, kv = 2 * elem * heads, 2 * elem * kv_heads
    stat, seg = 4 * rows * cap * heads, 4 * rows * cap
    p = pairs * heads
    return {
        "fwd": (4.0 * d_head * p, 2 * qo + 2 * kv + stat + seg),
        "dq": (6.0 * d_head * p, 3 * qo + 2 * kv + 2 * stat + seg),
        "dkv": (8.0 * d_head * p, 2 * qo + 4 * kv + 2 * stat + seg),
    }


def ssd_work(b: int, s: int, h: int, p: int, n: int, chunk: int, elem: int = 2) -> tuple:
    """(FLOPs, bytes) of one K7 call with its final state: C·Bᵀ once per
    (row, chunk) and, per (row, head, chunk), W·x over the causal pairs,
    C·state and the state update; x, adt, dt, B, C read once, y and the fp32
    final state written once.  ``s`` is a multiple of ``chunk``."""
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * (b * nc * pairs * n + b * h * nc * (pairs * p + 2 * chunk * p * n))
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * n) + 4 * (2 * b * s * h + b * h * p * n)
    return flops, nbytes
