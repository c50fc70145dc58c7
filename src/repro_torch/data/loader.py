"""OnlineDynamicLoader — the ODB DataLoader wrapper (paper §2.1, §2.4).

Ties the substrate together:

    sampler (identity views)  →  online pipeline (realized lengths)
      →  DGAP protocol engine (grouping + cross-rank alignment)
        →  step-aligned per-rank Groups  →  batch layout  →  train step

The padded-vs-packed decision is a pluggable :class:`BatchLayout`
(DESIGN.md §10): the loader builds one :class:`DeviceBatch` per rank per
aligned step through whichever layout it was constructed with, so every
downstream consumer (trainer, prefetcher, workers) is layout-agnostic.

The loader exposes three surfaces:

  * ``odb_schedule(...)`` — the list of aligned steps of per-rank
    Groups/IDLE for one epoch, with its audit;
  * ``OnlineDynamicLoader.streaming_epoch`` — the trainer's default: the
    streaming executor over a bounded admission window, with an optional
    prefetch thread, worker processes and staging of the step arrays on the
    card (DESIGN.md §9, §14); checkpointable mid-epoch;
  * ``OnlineDynamicLoader.epoch`` — the eager path (every length realized up
    front), kept as the equivalence reference.

Both iterators yield (per-rank DeviceBatch list, StepMetadata) per aligned
step, with the epoch-level audit (Theorems 1/2) in ``last_audit`` after
iteration.  ``torch`` is imported only where a step is staged on a device:
the spawned worker processes import this module and must not load it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator, Sequence

from repro_torch.core.buckets import BucketSpec, PackedBucketSpec
from repro_torch.core.grouping import Group
from repro_torch.core.layout import (
    BatchLayout,
    DeviceBatch,
    global_batch_arrays,
    make_layout,
)
from repro_torch.core.metadata import EmitAccounting, StepMetadata, step_metadata
from repro_torch.core.protocol import IDLE, EpochAudit, OdbConfig, run_epoch
from repro_torch.data.datasets import DatasetSpec
from repro_torch.data.pipeline import PipelinePolicy, realize_lengths
from repro_torch.data.sampler import (
    ITERATION_VIEW_ID_STRIDE,
    SamplerSpec,
    iteration_shuffle_epoch,
    shard_views,
)

# NOTE: repro_torch.stream is imported lazily inside streaming_epoch().  A
# module-level import would close an import cycle (stream.executor ->
# repro_torch.data.pipeline -> repro_torch.data.__init__ -> loader -> stream)
# and make `import repro_torch.stream` fail whenever it is the first
# repro_torch import.


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
class StagedArrays:
    """The global step arrays of one step, staged on a device.

    On a CUDA device the copies were issued on the stager's own stream:
    ``event`` is recorded after them, and the consumer's stream must wait on
    it before reading ``arrays`` (``train.trainer.assemble_model_batch``).
    ``host`` keeps the pinned source tensors alive until the step is done.
    On the CPU ``arrays`` are CPU tensors and ``event``/``host`` are None.
    """

    arrays: dict  # name -> tensor on the staging device
    event: object = None  # torch.cuda.Event, or None on the CPU
    host: dict | None = None  # pinned host tensors the copies read


@dataclasses.dataclass
class LoaderStep:
    batches: list[DeviceBatch]  # one per rank (IDLE ranks are zero batches)
    metadata: StepMetadata
    # Global step arrays already staged on the device, populated by the
    # prefetch producer (or inline) when device-put staging is enabled, so
    # the H2D copy hides under the consumer's step.
    device: StagedArrays | None = None
    # Worker-path slot handle (DESIGN.md §14): with num_workers > 0 the
    # batch arrays are zero-copy views over a shared-memory ring slot;
    # calling ``release_slot`` recycles the slot.  The loader calls it at
    # the consumer boundary (after the trainer finishes with the step);
    # idempotent, and a no-op on the in-process path.
    release: object = None

    def release_slot(self) -> None:
        if self.release is not None:
            self.release()

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
        num_hosts: int = 1,
    ) -> None:
        self.dataset = dataset
        self.world_size = world_size
        self.config = config
        self.policy = policy or dataset.policy
        self.seed = seed
        self.vocab_size = vocab_size
        self.num_hosts = num_hosts
        self.bucket_spec = bucket_spec or BucketSpec(
            max_len=self.policy.cutoff_len, max_count=4096
        )
        self.accounting = EmitAccounting()
        self.last_audit: EpochAudit | None = None
        self.last_executor = None  # StreamExecutor of the last streaming epoch
        self.last_prefetch_stats = None
        self.last_worker_stats = None  # WorkerPoolStats of the last worker epoch
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

        Pure: ``accounting`` is updated at the *consumption* point, not here
        — the prefetch producer builds steps the consumer may never take, and
        abandoned staged steps must not count as emitted.
        """
        row = self.layout.build_step(step)
        return LoaderStep(batches=row, metadata=step_metadata(index, step))

    def epoch(
        self, epoch: int = 0, *, device_put: bool = False, device=None
    ) -> Iterator[LoaderStep]:
        """Eager path: realize every length, schedule the whole epoch, then
        deliver (the offline regime the streaming path replaces — kept for
        audits and as the equivalence reference).  ``device_put`` stages the
        assembled arrays on ``device`` inline (no producer thread to overlap
        with here, but the flag keeps eager/streaming comparisons honest)."""
        records = self.dataset.records(self.seed)
        lengths = realize_lengths(records, self.policy, epoch)
        steps, audit = odb_schedule(
            lengths, self.world_size, self.config, seed=self.seed, epoch=epoch
        )
        self.last_audit = audit
        stage = self._device_stager(device) if device_put else None
        for i, step in enumerate(steps):
            loader_step = self._layout_step(i, step)
            if stage is not None:
                loader_step = stage(loader_step)
            self.accounting.update(
                loader_step.metadata, device_tokens=loader_step.device_tokens
            )
            yield loader_step

    def _device_stager(self, device):
        """The staging hook of one epoch: ``_stage_device`` onto ``device``
        (``None`` = the CUDA card, as everywhere in the port), on a CUDA
        stream of the hook's own, made here."""
        from repro_torch.device import resolve_device

        device = resolve_device(device)
        stream = None
        if device.type == "cuda":
            import torch

            stream = torch.cuda.Stream(device)

        def stage(loader_step: LoaderStep) -> LoaderStep:
            return self._stage_device(loader_step, device, stream)

        return stage

    def _stage_device(self, loader_step: LoaderStep, device, stream) -> LoaderStep:
        """Assemble the global step arrays and issue their copies to
        ``device`` — runs on the prefetch producer thread, so the H2D copy
        hides under the consumer's step.

        CUDA: the arrays go to pinned host memory, the copies are issued
        ``non_blocking`` on ``stream`` (under ``torch.cuda.device``, since the
        current device is per thread), and an event recorded after them
        rides in ``loader_step.device``.  CPU: the arrays are wrapped as CPU
        tensors, with no pinning, stream or event.  The source arrays are
        fresh copies made by ``global_batch_arrays``, never shared-memory
        views, so nothing here reads a worker's ring slot.
        """
        import torch

        arrays = global_batch_arrays(loader_step.batches, self.layout)
        if stream is None:
            loader_step.device = StagedArrays(
                {k: torch.from_numpy(v) for k, v in arrays.items()}
            )
            return loader_step
        with torch.cuda.device(device), torch.cuda.stream(stream):
            host = {k: torch.from_numpy(v).pin_memory() for k, v in arrays.items()}
            staged = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        loader_step.device = StagedArrays(staged, event, host)
        return loader_step

    def streaming_epoch(
        self,
        epoch: int = 0,
        *,
        lookahead: int | None = None,
        prefetch: bool = False,
        prefetch_depth: int = 2,
        device_put: bool = False,
        num_workers: int = 0,
        worker_slots: int | None = None,
        worker_slot_bytes: int | None = None,
        resume_from: "StreamCheckpoint | None" = None,
        finalize_audit: bool = True,
        fault_injector=None,
        device=None,
    ) -> Iterator[LoaderStep]:
        """Online path (DESIGN.md §9): batch formation happens at the point
        where realized lengths become observable.

        Views are admitted through a bounded-lookahead window (at most
        ``lookahead`` realized lengths in flight — defaults to the sampler's
        full view multiset M, which reproduces the eager schedule
        bit-for-bit), protocol rounds interleave with delivery, and with
        ``prefetch=True`` realization + grouping + padding run in a
        background thread, double-buffered against the train step.  With
        ``device_put=True`` the step arrays are staged on ``device`` (``None``
        = the CUDA card) by the producer (see :meth:`_stage_device`).

        Mid-epoch state is checkpointable: take ``loader.last_executor
        .checkpoint()`` between steps, then pass the checkpoint back as
        ``resume_from`` to continue the identical step sequence.  With
        ``prefetch=True`` the producer runs ahead of the consumer, so to
        checkpoint exactly at the consumer's frontier, close the iterator
        first (with ``finalize_audit=False``) — the staged-but-unconsumed
        tail is rolled back into the executor on close — and checkpoint
        afterwards.  A checkpoint taken while the producer is live is still
        a *consistent* step boundary, but of the producer-side frontier.

        With ``num_workers > 0`` (DESIGN.md §14) the layout realization —
        packing plans, bucket padding, token synthesis — runs in a pool of
        spawn-based worker processes with results returned through
        shared-memory ring slots; protocol rounds stay in-parent (task
        emission via ``executor.next_task()``), so the delivered step stream
        is bit-identical to ``num_workers=0`` and checkpoints are
        worker-count-agnostic (the pool holds no checkpointable state).

        The epoch audit is published to ``last_audit`` when iteration
        completes.
        """
        from repro_torch.stream.executor import StreamExecutor
        from repro_torch.stream.prefetch import PrefetchIterator

        # First, so a missing card raises before any executor or pool exists.
        stage_device = self._device_stager(device) if device_put else None
        records = self.dataset.records(self.seed)
        if resume_from is not None:
            ck_epoch = resume_from.epoch
            ck_lookahead = resume_from.payload["lookahead"]
            # epoch=0 is the default and means "whatever the checkpoint
            # holds"; any explicit different epoch is a caller error.
            if epoch not in (0, ck_epoch):
                raise ValueError(
                    f"resume_from checkpoint is for epoch {ck_epoch}, "
                    f"but epoch={epoch} was requested"
                )
            if lookahead is not None and lookahead != ck_lookahead:
                raise ValueError(
                    f"resume_from checkpoint was taken with lookahead "
                    f"{ck_lookahead}, but lookahead={lookahead} was requested"
                )
            executor = StreamExecutor.resume(
                resume_from,
                records,
                self.policy,
                fault_injector=fault_injector,
                # Resume at the loader's *current* host count: v4 window
                # state is per-rank, so an elastic host-count change
                # continues the identical step sequence (DESIGN.md §16).
                num_hosts=self.num_hosts,
            )
        else:
            executor = StreamExecutor(
                records,
                self.policy,
                self.world_size,
                self.config,
                seed=self.seed,
                epoch=epoch,
                lookahead=lookahead,
                fault_injector=fault_injector,
                num_hosts=self.num_hosts,
            )
        self.last_executor = executor

        pool = None
        if num_workers and num_workers > 0:
            from repro_torch.stream.workers import DEFAULT_SLOT_BYTES, WorkerPool

            pool = WorkerPool(
                self.layout,
                num_workers,
                slots=worker_slots,
                slot_bytes=worker_slot_bytes or DEFAULT_SLOT_BYTES,
            )
            self.last_worker_stats = pool.stats

        staged: collections.deque[list] = collections.deque()

        def produce(track: bool = False) -> Iterator[LoaderStep]:
            while True:
                step = executor.step()
                if step is None:
                    return
                built = self._layout_step(executor.runner.steps_delivered - 1, step)
                if track:
                    staged.append(step)
                yield built

        def produce_pool(track: bool = False) -> Iterator[LoaderStep]:
            # Pump loop: keep the pool's task queue fed (one free shm slot
            # per submission = the backpressure bound), then deliver the
            # next in-order result.  Steps are staged at *submission* so an
            # abandoned epoch can roll every unconsumed step back into the
            # executor — submission order equals delivery order (seq-ordered
            # reorder buffer), so the staged deque's tail is exactly the
            # undelivered suffix.
            del track  # the pool path always tracks (it always runs ahead)
            done = False
            while True:
                while not done and pool.can_submit():
                    task = executor.next_task()
                    if task is None:
                        done = True
                        break
                    pool.submit(*task)
                    staged.append(task[1])
                if done and not pool.inflight:
                    return
                res = pool.take()
                if res is None:
                    continue
                yield LoaderStep(
                    batches=res.batches,
                    metadata=step_metadata(res.index, res.step),
                    release=res.release,
                )

        def stage_release(built: LoaderStep) -> LoaderStep:
            # Worker path + device_put: once global_batch_arrays has copied
            # the host views into the assembled step arrays, the shm slot
            # can recycle immediately — no need to hold it to the consumer
            # boundary (batches keep only shapes/metadata after this).
            built = stage_device(built)
            built.release_slot()
            return built

        source = produce_pool if pool is not None else produce

        try:
            if prefetch:
                stage = None
                if device_put:
                    stage = stage_device if pool is None else stage_release
                it = PrefetchIterator(
                    source(track=True),
                    depth=prefetch_depth,
                    stage=stage,
                )
                self.last_prefetch_stats = it.stats
                try:
                    for built in it:
                        staged.popleft()  # consumed: off the rollback ledger
                        self.accounting.update(
                            built.metadata, device_tokens=built.device_tokens
                        )
                        yield built
                        built.release_slot()  # consumer boundary: recycle shm
                finally:
                    # Blocks until the producer's in-flight step finishes
                    # (bounded by the protocol termination envelope) — the
                    # rollback below is only sound with the producer stopped.
                    it.close()
                    if pool is not None:
                        pool.close()
                    # Rewind the executor to the consumer's frontier: the
                    # producer ran ahead, and the staged-but-unconsumed tail
                    # would otherwise be counted delivered yet never trained
                    # on — a silent coverage gap across checkpoint/resume.
                    if staged:
                        executor.requeue(list(staged))
                        staged.clear()
            else:
                track = pool is not None
                try:
                    for built in source(track=track):
                        if track:
                            staged.popleft()
                        if device_put:
                            built = stage_device(built)
                        self.accounting.update(
                            built.metadata, device_tokens=built.device_tokens
                        )
                        yield built
                        built.release_slot()
                finally:
                    if pool is not None:
                        pool.close()
                    if staged:
                        executor.requeue(list(staged))
                        staged.clear()
        finally:
            if pool is not None:
                pool.close()
            # Epoch-level audit contract (Theorem 1): even when the consumer
            # stops early (max_steps), finish the remaining *data-side*
            # schedule — grouping/alignment only, no padding, no compute — so
            # ``last_audit`` reflects the full epoch exactly like the eager
            # path.  ``finalize_audit=False`` skips the drain for callers
            # that must exit promptly (preemption after a checkpoint): they
            # hold the executor (``last_executor``) and its checkpoint, and
            # ``last_audit`` then reflects only the delivered prefix.
            # An aborted epoch (EpochAborted, DESIGN.md §15.4) must not be
            # drained — the executor latched after an unrecoverable round
            # fault and every further step() re-raises; the caller recovers
            # via the abort checkpoint, and last_audit reflects the prefix.
            if finalize_audit and not executor.aborted:
                while executor.step() is not None:
                    pass
            self.last_audit = executor.audit()
