"""Card time of the train step's backward a step, in ms (``autograd.grad``
with the per-layer recompute): ``train_backward_device_seconds_total`` over
``train_steps_total``, as ``forward_ms`` reads its counter."""

from odb_bench.metrics.forward_ms import per_step


def read(ctx):
    return per_step(ctx, "train_backward_device_seconds_total", 1e3)
