"""K7's share of its roofline over the profiled steps, in %: the bound time
of every SSD forward call (``bounds.ssd_work`` at the step's rows and
chunk-padded length, the configuration's heads, head size, state and
chunk) over the device time of its kernels.  A call launches each of its
kernels once, so the calls are the most launched of the ``ssd_`` kernels."""

from odb_bench import bounds


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profiled:
        return None
    ssd = p.kernels(lambda n: "ssd_" in n)
    if not ssd:
        return None
    names: dict = {}
    for name, *_ in ssd:
        names[name] = names.get(name, 0) + 1
    calls = max(names.values()) / len(ctx.profiled)
    a = ctx.config["assumed"]
    d_inner = a["expand"] * ctx.config["d_model"]
    q = a["chunk_size"]
    bound = 0.0
    for rows, cap, _ in ctx.profiled:
        s = -(-cap // q) * q
        bound += calls * bounds.bound_s(*bounds.ssd_work(rows, s, d_inner // a["headdim"], a["headdim"],
                                                         a["d_state"], q))
    return 100.0 * bound / p.device_s(lambda n: "ssd_" in n)
