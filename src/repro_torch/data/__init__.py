"""Data substrate: sampler, online pipeline, datasets, the eager loader."""

from repro_torch.data.datasets import (
    DATASET_CLONES,
    SYNTHETIC_DISTRIBUTIONS,
    DatasetSpec,
    get_dataset,
)
from repro_torch.data.loader import LoaderStep, OnlineDynamicLoader, odb_schedule
from repro_torch.data.pipeline import PipelinePolicy, RawRecord, realize_lengths
from repro_torch.data.sampler import SamplerSpec, global_view_order, shard_views

__all__ = [
    "DATASET_CLONES",
    "SYNTHETIC_DISTRIBUTIONS",
    "DatasetSpec",
    "LoaderStep",
    "OnlineDynamicLoader",
    "PipelinePolicy",
    "RawRecord",
    "SamplerSpec",
    "get_dataset",
    "global_view_order",
    "odb_schedule",
    "realize_lengths",
    "shard_views",
]
