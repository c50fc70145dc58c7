"""Share of the profiled window with nothing running on the card."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 1.0 - p.busy_s / p.window_s
