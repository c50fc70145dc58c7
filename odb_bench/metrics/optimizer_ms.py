"""Card time of the train step's optimizer a step, in ms (the gradient clip
and the per-leaf AdamW): ``train_optimizer_device_seconds_total`` over
``train_steps_total``, as ``forward_ms`` reads its counter."""

from odb_bench.metrics.forward_ms import per_step


def read(ctx):
    return per_step(ctx, "train_optimizer_device_seconds_total", 1e3)
