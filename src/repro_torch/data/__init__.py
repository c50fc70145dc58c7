"""Data substrate: sampler, online pipeline, datasets, loaders, baselines."""

from repro_torch.data.baselines import (
    packing_schedule,
    sorted_schedule,
    standard_schedule,
)
from repro_torch.data.datasets import (
    DATASET_CLONES,
    SYNTHETIC_DISTRIBUTIONS,
    DatasetSpec,
    get_dataset,
)
from repro_torch.data.loader import LoaderStep, OnlineDynamicLoader, odb_schedule
from repro_torch.data.oracles import (
    LengthCache,
    StaleCacheError,
    bmt_schedule,
    gmt_schedule,
    hfg_schedule,
)
from repro_torch.data.pipeline import (
    PipelinePolicy,
    RawRecord,
    length_cv,
    realize_lengths,
    run_pipeline,
    short_sample_fraction,
)
from repro_torch.data.sampler import SamplerSpec, global_view_order, shard_views

__all__ = [
    "DATASET_CLONES",
    "SYNTHETIC_DISTRIBUTIONS",
    "DatasetSpec",
    "LengthCache",
    "LoaderStep",
    "OnlineDynamicLoader",
    "PipelinePolicy",
    "RawRecord",
    "SamplerSpec",
    "StaleCacheError",
    "bmt_schedule",
    "get_dataset",
    "global_view_order",
    "gmt_schedule",
    "hfg_schedule",
    "length_cv",
    "odb_schedule",
    "packing_schedule",
    "realize_lengths",
    "run_pipeline",
    "shard_views",
    "short_sample_fraction",
    "sorted_schedule",
    "standard_schedule",
]
