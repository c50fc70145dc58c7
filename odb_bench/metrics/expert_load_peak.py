"""The busiest held expert against the mean of the held experts, over the
window: ``moe_held_peak_pairs_total`` (each MoE layer's busiest held expert's
pairs, summed) over ``moe_held_pairs_total`` / the experts held (the
configuration's ``n_routed_experts``).  1 is an even load; the grouped
products' time follows the mean, a device padded to capacity the peak."""


def read(ctx):
    held = ctx.counters.get("moe_held_pairs_total", 0.0)
    peak = ctx.counters.get("moe_held_peak_pairs_total", 0.0)
    if not held or not peak:
        return None
    return peak / (held / ctx.config["n_routed_experts"])
