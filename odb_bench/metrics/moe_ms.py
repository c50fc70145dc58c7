"""Device time of the whole MoE layer a profiled step, in ms: routing,
dispatch, the grouped products, the combine and the shared experts, over
every MoE layer.  Forward and recompute: the kernels launched inside the
``moe/layer`` profiler ranges.  Backward: on each thread, the kernels
launched between the end of a ``_MoeExitBackward`` autograd node and the
end of the next ``_MoeEnterBackward`` node (the program's boundary nodes,
between which the engine runs the layer's backward; the recompute runs
inside the exit node and is counted by its range).  The profiler's own
device rows for the ranges (``moe/...``, spans, not kernels) are left out."""

NODE = "autograd::engine::evaluate_function: "
ENTER, EXIT = NODE + "_MoeEnterBackward", NODE + "_MoeExitBackward"


def launched_within(p, windows: dict) -> float:
    """Device seconds of the kernels whose launching host op started inside
    one of ``windows`` ({thread: [(start_ns, end_ns)]})."""
    launched = {corr: (tid, s) for name, s, _, tid, corr in p.host if corr}
    total = 0
    for name, s, e, linked in p.device:
        op = launched.get(linked)
        if op and not name.startswith("moe/") and any(a <= op[1] <= b for a, b in windows.get(op[0], ())):
            total += e - s
    return total / 1e9


def ranges(p, name: str) -> dict:
    out: dict = {}
    for n, s, e, tid, _ in p.host:
        if n == name:
            out.setdefault(tid, []).append((s, e))
    return out


def backward_windows(p) -> dict:
    windows: dict = {}
    open_: dict = {}
    for name, s, e, tid, _ in sorted(p.host, key=lambda h: h[1]):
        if name == EXIT:
            open_[tid] = e
        elif name == ENTER and tid in open_:
            windows.setdefault(tid, []).append((open_.pop(tid), e))
    return windows


def read(ctx):
    p = ctx.profile
    if p is None or not p.steps:
        return None
    forward = launched_within(p, ranges(p, "moe/layer"))
    if not forward:
        return None
    return 1e3 * (forward + launched_within(p, backward_windows(p))) / p.steps
