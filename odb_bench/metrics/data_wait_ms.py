"""Host time a step waited on the data path: the trainer's
``train_realize_seconds_total`` over ``train_steps_total`` (the host clock
around the blocking ``next()`` of the step iterator), over the window."""


def read(ctx):
    steps = ctx.counters.get("train_steps_total", 0)
    if not steps:
        return None
    return 1e3 * ctx.counters.get("train_realize_seconds_total", 0.0) / steps
