"""Card time of the train step's forward a step, in ms: the trainer's
``train_forward_device_seconds_total`` over ``train_steps_total``, over the
window.  The trainer adds to it, while its tracer is on, the time between
CUDA events at the phase's boundaries (``StepPhases``), read after each
step's sync; a program without the counter, or a run off the card, leaves
the metric out."""


def per_step(ctx, counter: str, scale: float = 1.0):
    """``scale`` × the counter's delta over the window's steps; None where
    the counter is absent or zero."""
    steps = ctx.counters.get("train_steps_total", 0)
    value = ctx.counters.get(counter, 0.0)
    return scale * value / steps if steps and value else None


def read(ctx):
    return per_step(ctx, "train_forward_device_seconds_total", 1e3)
