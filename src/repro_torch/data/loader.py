"""OnlineDynamicLoader — the ODB DataLoader wrapper (paper §2.1, §2.4); a copy
of the JAX package's ``data/loader.py`` up to its eager path.

    sampler (identity views)  →  online pipeline (realized lengths)
      →  DGAP protocol engine (grouping + cross-rank alignment)
        →  step-aligned per-rank Groups  →  batch layout  →  train step

The loader exposes two surfaces:

  * ``odb_schedule(...)`` — the list of aligned steps of per-rank
    Groups/IDLE for one epoch, with its audit;
  * ``OnlineDynamicLoader.epoch`` — the trainer-facing iterator yielding
    (per-rank DeviceBatch list, StepMetadata) per aligned step, with the
    epoch-level audit (Theorems 1/2) in ``last_audit`` after iteration.

The streaming executor (``streaming_epoch``), its prefetch thread and the
worker processes are not ported yet; the host arrays go to the card in the
trainer (``assemble_model_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

from repro_torch.core.buckets import BucketSpec, PackedBucketSpec
from repro_torch.core.grouping import Group
from repro_torch.core.layout import (
    BatchLayout,
    DeviceBatch,
    make_layout,
)
from repro_torch.core.metadata import EmitAccounting, StepMetadata, step_metadata
from repro_torch.core.protocol import EpochAudit, OdbConfig, run_epoch
from repro_torch.data.datasets import DatasetSpec
from repro_torch.data.pipeline import PipelinePolicy, realize_lengths
from repro_torch.data.sampler import (
    ITERATION_VIEW_ID_STRIDE,
    SamplerSpec,
    iteration_shuffle_epoch,
    shard_views,
)


def odb_schedule(
    lengths: Sequence[int],
    world_size: int,
    config: OdbConfig,
    *,
    seed: int = 0,
    epoch: int = 0,
    drain_rates: Sequence[int | None] | None = None,
) -> tuple[list[list[Group | None]], EpochAudit]:
    """Run one epoch of the ODB protocol; return aligned steps + audit."""
    spec = SamplerSpec(dataset_size=len(lengths), world_size=world_size, seed=seed)

    def make_views(iteration: int):
        return shard_views(
            spec,
            iteration_shuffle_epoch(epoch, iteration),
            lengths,
            view_id_base=iteration * ITERATION_VIEW_ID_STRIDE,
        )

    steps: list[list[Group | None]] = []
    audit = run_epoch(
        make_views,
        len(lengths),
        config,
        on_step=steps.append,
        drain_rates=drain_rates,
    )
    return steps, audit


@dataclasses.dataclass
class LoaderStep:
    batches: list[DeviceBatch]  # one per rank (IDLE ranks are zero batches)
    metadata: StepMetadata

    @property
    def device_tokens(self) -> int:
        """Token slots this step occupies on device under its layout."""
        return sum(b.area for b in self.batches)


class OnlineDynamicLoader:
    """Drop-in iterator over step-aligned, bucket-padded ODB batches.

    Mirrors the paper's API: wraps the (sampler, pipeline, dataset) triple,
    leaves both untouched, and emits per-step metadata for trainer-side
    accounting + token-level loss scaling.  Lengths are realized through the
    online pipeline at iteration time — there is no length precompute.
    """

    def __init__(
        self,
        dataset: DatasetSpec,
        world_size: int,
        config: OdbConfig,
        *,
        bucket_spec: BucketSpec | None = None,
        packed_spec: PackedBucketSpec | None = None,
        layout: str | BatchLayout = "dense",
        policy: PipelinePolicy | None = None,
        seed: int = 0,
        vocab_size: int = 32000,
    ) -> None:
        self.dataset = dataset
        self.world_size = world_size
        self.config = config
        self.policy = policy or dataset.policy
        self.seed = seed
        self.vocab_size = vocab_size
        self.bucket_spec = bucket_spec or BucketSpec(
            max_len=self.policy.cutoff_len, max_count=4096
        )
        self.accounting = EmitAccounting()
        self.last_audit: EpochAudit | None = None
        # Row-capacity grid floor stays well below the token budget so
        # near-empty tail groups don't inflate to a full window; the ceiling
        # must admit the longest realizable sample (one row always fits one
        # sample).  Granularity (floor + alignment) mirrors the dense bucket
        # grid so the padded-vs-packed comparison is apples-to-apples.
        self.packed_spec = packed_spec or PackedBucketSpec(
            min_tokens=max(self.bucket_spec.min_len, config.l_max // 8),
            max_tokens=max(2 * config.l_max, self.policy.cutoff_len, 2048),
            align=self.bucket_spec.align,
        )
        if isinstance(layout, str):
            layout = make_layout(
                layout,
                bucket_spec=self.bucket_spec,
                packed_spec=self.packed_spec,
                vocab_size=vocab_size,
            )
        self.layout = layout

    def _layout_step(self, index: int, step: list[Group | None]) -> LoaderStep:
        """Realize one aligned step through the batch layout (IDLE ranks
        become zero batches of the step shape; all ranks share the planned
        SPMD shape, so ``device_tokens`` is exactly what ships to device).

        Pure: ``accounting`` is updated at the *consumption* point, not here.
        """
        row = self.layout.build_step(step)
        return LoaderStep(batches=row, metadata=step_metadata(index, step))

    def epoch(self, epoch: int = 0) -> Iterator[LoaderStep]:
        """Eager path: realize every length, schedule the whole epoch, then
        deliver (the offline regime the streaming path replaces — kept for
        audits and as the equivalence reference).  At the default lookahead
        the JAX package's ``streaming_epoch`` delivers this exact sequence."""
        records = self.dataset.records(self.seed)
        lengths = realize_lengths(records, self.policy, epoch)
        steps, audit = odb_schedule(
            lengths, self.world_size, self.config, seed=self.seed, epoch=epoch
        )
        self.last_audit = audit
        for i, step in enumerate(steps):
            loader_step = self._layout_step(i, step)
            self.accounting.update(
                loader_step.metadata, device_tokens=loader_step.device_tokens
            )
            yield loader_step
