"""Streaming DGAP execution: bounded-lookahead admission, incremental
scheduling, async prefetch, multi-process realization workers, resumable
loader state, and the sharded multi-host window (DESIGN.md §9, §14, §16)."""

from repro_torch.stream.executor import EpochAborted, StreamExecutor
from repro_torch.stream.prefetch import PrefetchIterator, PrefetchStats
from repro_torch.stream.state import StreamCheckpoint
from repro_torch.stream.window import (
    AdmissionWindow,
    BoundedWindow,
    QuarantineLedger,
    ShardedWindow,
    WindowRouter,
    WindowStats,
    host_rank_blocks,
    split_lookahead,
)
from repro_torch.stream.workers import WorkerPool, WorkerPoolStats, WorkerResult

__all__ = [
    "AdmissionWindow",
    "BoundedWindow",
    "EpochAborted",
    "PrefetchIterator",
    "PrefetchStats",
    "QuarantineLedger",
    "ShardedWindow",
    "StreamCheckpoint",
    "StreamExecutor",
    "WindowRouter",
    "WindowStats",
    "WorkerPool",
    "WorkerPoolStats",
    "WorkerResult",
    "host_rank_blocks",
    "split_lookahead",
]
