"""The flash kernels' share of their roofline over the profiled steps, in %:
the bound time of every forward (K4), dQ (K5) and dK/dV (K6) launch
(``bounds.flash_work`` at the step's packed shape and visible pairs, the
configuration's heads and head size) over their device time.  Launches per
step and layer are counted from the trace, so remat's second forward is
bound as the work it is."""

from odb_bench import bounds

KINDS = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profiled:
        return None
    counts = {k: len(p.kernels(lambda n, s=s: s in n)) for k, s in KINDS.items()}
    device_s = p.device_s(lambda n: any(s in n for s in KINDS.values()))
    if not device_s:
        return None
    c = ctx.config
    heads, kv, dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    bound = 0.0
    for rows, cap, lengths in ctx.profiled:
        work = bounds.flash_work(rows, cap, heads, kv, dh, bounds.visible_pairs(lengths))
        bound += sum(counts[k] / len(ctx.profiled) * bounds.bound_s(*work[k]) for k in KINDS)
    return 100.0 * bound / device_s
