"""Share of the profiled device time spent in the SSD's backward: the
kernels launched under the profiler's autograd node of ``_SsdScan``'s
backward (the plain chunked form's gradient, recomputed under autograd)."""

NODE = "autograd::engine::evaluate_function: _SsdScanBackward"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    under = p.device_s_under(NODE)
    total = p.device_s()
    return under / total if under and total else None
