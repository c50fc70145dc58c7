"""Core ODB library: grouping, alignment, the DGAP protocol, batch layouts
(copies of the JAX package's framework-neutral modules)."""

from repro_torch.core.buckets import BucketSpec, PackedBucketSpec
from repro_torch.core.grouping import Group, Sample, greedy_group
from repro_torch.core.layout import (
    BatchLayout,
    DenseLayout,
    DeviceBatch,
    PackedLayout,
    global_batch_arrays,
    make_layout,
    unify_step_shapes,
)
from repro_torch.core.loss_scaling import (
    RankLossStats,
    ddp_scaled_loss,
    prescale_factor,
    prescaled_loss,
    reference_per_token_loss,
    sample_weights,
    token_weights,
)
from repro_torch.core.metadata import StepMetadata
from repro_torch.core.protocol import IDLE, EpochAudit, OdbConfig, run_epoch

__all__ = [
    "IDLE",
    "BatchLayout",
    "BucketSpec",
    "DenseLayout",
    "DeviceBatch",
    "EpochAudit",
    "Group",
    "OdbConfig",
    "PackedBucketSpec",
    "PackedLayout",
    "RankLossStats",
    "Sample",
    "StepMetadata",
    "global_batch_arrays",
    "ddp_scaled_loss",
    "greedy_group",
    "make_layout",
    "prescale_factor",
    "prescaled_loss",
    "reference_per_token_loss",
    "run_epoch",
    "sample_weights",
    "token_weights",
    "unify_step_shapes",
]
