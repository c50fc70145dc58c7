"""Liveness-table builds of the pruned flash route a step:
``kernel_liveness_tables_built_total`` (one per flash forward on the card,
``kernels/ops._Flash``) over ``train_steps_total``, over the window."""

from odb_bench.metrics.forward_ms import per_step


def read(ctx):
    return per_step(ctx, "kernel_liveness_tables_built_total")
