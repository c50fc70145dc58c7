"""MLA's kernels' share of their roofline over the profiled steps, in %: the
bound time of every forward (``mla_fwd``), dQ (``mla_bwd_dq``) and dK/dV
(``mla_bwd_dkv``) launch over the device time of those kernels.  A launch is
bound at its step's packed shape and visible pairs (:func:`mla_work`, the
configuration's heads and widths); launches per step are counted from the
trace, so remat's second forward is bound as the work it is.  A program
without these kernels gives nothing to read."""

from odb_bench import bounds

KINDS = {"fwd": "mla_fwd", "dq": "mla_bwd_dq", "dkv": "mla_bwd_dkv"}


def mla_work(rows: int, cap: int, heads: int, nope: int, rope: int, v_dim: int, pairs: int) -> dict:
    """(FLOPs, bytes) of the forward, dQ and dK/dV passes of one bf16 MLA
    call over a (rows, cap) packed batch: 2 (qk + v), 2 (2 qk + v) and
    4 (qk + v) FLOPs per visible pair and head (qk = nope + rope); q, k_nope,
    the shared k_rope, v, out, dout, the gradients, the fp32 row statistics
    and the segment ids moved once."""
    qk, t = nope + rope, rows * cap
    q, kn, kr, v = 2 * t * heads * qk, 2 * t * heads * nope, 2 * t * rope, 2 * t * heads * v_dim
    stat, seg = 4 * t * heads, 4 * t
    inputs = q + kn + kr + v + seg
    p = pairs * heads
    return {
        "fwd": (2.0 * (qk + v_dim) * p, inputs + v + stat),
        "dq": (2.0 * (2 * qk + v_dim) * p, inputs + v + 2 * stat + q),
        "dkv": (4.0 * (qk + v_dim) * p, inputs + v + 2 * stat + kn + kr + v),
    }


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profiled:
        return None
    counts = {k: len(p.kernels(lambda n, s=s: s in n)) for k, s in KINDS.items()}
    device_s = p.device_s(lambda n: any(s in n for s in KINDS.values()))
    if not device_s:
        return None
    c = ctx.config
    widths = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"])
    bound = 0.0
    for rows, cap, lengths in ctx.profiled:
        work = mla_work(rows, cap, *widths, bounds.visible_pairs(lengths))
        bound += sum(counts[k] / len(ctx.profiled) * bounds.bound_s(*work[k]) for k in KINDS)
    return 100.0 * bound / device_s
