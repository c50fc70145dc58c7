"""The held experts' grouped products' share of their roofline over the
profiled steps, in %: their least time, by ``flops/<family>.expert_work``
over the pairs they computed, over the device time of the kernels launched
inside the ``moe/experts`` profiler ranges (``moe_ms.launched_within``) (the forward and the per-layer
recompute) and inside the ``_HeldExpertsBackward`` autograd node.  The
forward and the recompute each count as one forward's work and the
backward as two.  A profiled step's pairs in each MoE layer are its token
slots (every slot is routed) times top-k times the window's share of routed
pairs that were held (``moe_held_pairs_total`` over
``moe_routed_pairs_total``): every layer is bound at that mean."""

from odb_bench import bounds
from odb_bench.metrics.moe_ms import launched_within, ranges

RANGE = "moe/experts"
BACKWARD = "autograd::engine::evaluate_function: _HeldExpertsBackward"


def read(ctx):
    p = ctx.profile
    routed = ctx.counters.get("moe_routed_pairs_total", 0.0)
    held = ctx.counters.get("moe_held_pairs_total", 0.0)
    if p is None or not ctx.profiled or not routed or not held:
        return None
    device_s = launched_within(p, ranges(p, RANGE)) + launched_within(p, ranges(p, BACKWARD))
    if not device_s:
        return None
    c = ctx.config
    layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    bound = 0.0
    for rows, cap, _ in ctx.profiled:
        pairs = rows * cap * c["num_experts_per_tok"] * held / routed  # a layer's, this step
        bound += 4 * layers * bounds.bound_s(*ctx.flops.expert_work(
            pairs, c["hidden_size"], c["moe_intermediate_size"], c["n_routed_experts"]))
    return 100.0 * bound / device_s
