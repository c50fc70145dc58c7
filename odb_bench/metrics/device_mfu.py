"""The whole step's share of the card's bf16 peak while the card is busy,
in %: the profiled steps' model FLOPs (``flops/<family>.py``: forward and
backward of the real tokens, no recompute, no padding) over the device's
busy seconds in the trace (every kernel, copy and set, their union) and
989 TFLOP/s.  It leaves out the idle time that the end-to-end ``mfu``
counts, so it bounds what the kernels of the step do together: a kernel
taken off the path leaves its roofline silent, and this share still reads."""

from odb_bench import bounds


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or p.busy_s <= 0 or not ctx.profiled:
        return None
    flops = sum(ctx.flops.train_flops(ctx.config, lengths) for _, _, lengths in ctx.profiled)
    return 100.0 * flops / (p.busy_s * bounds.PEAK_FLOPS)
