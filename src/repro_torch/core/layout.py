"""Pluggable batch-layout engine (DESIGN.md §10).

A *layout* decides what an aligned ODB ``Group`` becomes on device.  Both
built-in layouts emit the same :class:`DeviceBatch` contract — tokens,
within-segment positions, segment ids, loss mask, per-row lengths plus
accounting metadata — which is exactly what ``LM.loss_sums`` consumes, so the
loader, trainer, jitted step and benchmarks are all layout-agnostic:

  * :class:`DenseLayout` — the paper-deployed form: one sample per row,
    right-padded to a geometric ``(count, length)`` bucket
    (:class:`~repro_torch.core.buckets.BucketSpec`).  Contamination-free by
    construction (rows are independent batch elements under causal masking).
  * :class:`PackedLayout` — contamination-free packing: samples are first-fit
    packed into ``(rows, row_capacity)`` segment-id-tagged streams.  The row
    capacity is searched over the grid for the minimum-area plan (it must fit
    the longest sample but never the whole stream), so Pallas kernel block
    shapes stay bounded while right-padding decays to the row tails; the row
    count is bucketed on a short grid to bound compiled programs.

Layout invariants shared by both (tests/test_layout.py):

  * every sample lands in exactly one row and never straddles a row border;
  * ``segments`` are non-zero exactly where ``loss_mask`` is non-zero, with a
    distinct id per sample within a row (0 = padding);
  * ``positions`` restart from 0 at every segment start;
  * token ids come from the one shared synthesis point
    (:func:`~repro_torch.core.buckets.sample_token_ids`), so the two layouts carry
    bit-identical streams for the same sample.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.buckets import BucketSpec, PackedBucketSpec, sample_token_ids
from repro_torch.core.grouping import Group


def _observe_step(name: str, row: Sequence["DeviceBatch"]) -> None:
    """Publish one built step's padding accounting (DESIGN.md §13).

    ``odb_layout_pad_fraction`` is the device-side padding share of the whole
    step (IDLE ranks included — their all-pad area is real device waste);
    ``odb_layout_pack_fill`` is the fill of the rank batches that carry real
    samples, i.e. how well the layout packs where there is anything to pack.
    """
    real = sum(b.real_tokens for b in row)
    area = sum(b.area for b in row)
    occupied_area = sum(b.area for b in row if b.real_samples)
    obs.counter(
        "odb_layout_real_tokens_total", help="real tokens laid out", layout=name
    ).inc(real)
    obs.counter(
        "odb_layout_device_tokens_total",
        help="device token slots shipped",
        layout=name,
    ).inc(area)
    obs.counter(
        "odb_layout_steps_total", help="aligned steps built", layout=name
    ).inc()
    if area:
        obs.gauge(
            "odb_layout_pad_fraction",
            help="device-side padding fraction of the last built step",
        ).set(1.0 - real / area)
    if occupied_area:
        obs.gauge(
            "odb_layout_pack_fill",
            help="real-token fill of non-IDLE rank batches in the last step",
        ).set(real / occupied_area)


@dataclasses.dataclass(frozen=True)
class DeviceBatch:
    """One rank's device-ready batch — the common output of every layout."""

    tokens: np.ndarray  # (rows, T) int32
    positions: np.ndarray  # (rows, T) int32 — within-segment positions
    segments: np.ndarray  # (rows, T) int32 — 0 = padding, >=1 per sample
    loss_mask: np.ndarray  # (rows, T) float32 — 1 on real tokens
    lengths: np.ndarray  # (rows,) int32 — real tokens per row (0 = pad row)
    real_samples: int
    real_tokens: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.tokens.shape  # type: ignore[return-value]

    @property
    def area(self) -> int:
        """Device-side token slots this batch occupies (rows × T)."""
        return int(self.tokens.shape[0] * self.tokens.shape[1])

    @property
    def padding_fraction(self) -> float:
        area = self.area
        return 1.0 - self.real_tokens / area if area else 0.0


def _zero_batch(shape: tuple[int, int]) -> DeviceBatch:
    rows, t = shape
    return DeviceBatch(
        tokens=np.zeros((rows, t), np.int32),
        positions=np.zeros((rows, t), np.int32),
        segments=np.zeros((rows, t), np.int32),
        loss_mask=np.zeros((rows, t), np.float32),
        lengths=np.zeros((rows,), np.int32),
        real_samples=0,
        real_tokens=0,
    )


class BatchLayout:
    """Strategy interface: Group → DeviceBatch, plus SPMD shape plumbing."""

    name: str = "abstract"
    #: whether the jitted step needs explicit positions/segments in the batch
    #: (dense rows are one-sample-per-row, so the model's arange default and
    #: causal masking already realize the identical objective).
    needs_segments: bool = False

    def build(self, group: Group) -> DeviceBatch:  # pragma: no cover
        raise NotImplementedError

    def build_step(self, step: Sequence[Group | None]) -> list[DeviceBatch]:
        """Realize one aligned step (IDLE = None) into same-shape batches.

        The returned batches already share the step-max shape, so what the
        per-batch accounting sums is exactly what the SPMD step ships to
        device.  Layouts may override to *plan* at step scope (the packed
        layout coordinates one row capacity across ranks instead of letting
        per-rank plans diverge and paying for it at unification).
        """
        built = [None if g is None else self.build(g) for g in step]
        real = [b for b in built if b is not None]
        shape = real[-1].shape if real else self.fallback_shape()
        row = self.unify(
            [self.idle_like(shape) if b is None else b for b in built]
        )
        _observe_step(self.name, row)
        return row

    def idle_like(self, shape: tuple[int, int]) -> DeviceBatch:
        """IDLE_DATA sentinel: an all-padding batch annihilated by Eq. 2."""
        return _zero_batch(shape)

    def fallback_shape(self) -> tuple[int, int]:  # pragma: no cover
        """Smallest legal shape — used for all-IDLE steps."""
        raise NotImplementedError

    # -- SPMD shape unification ------------------------------------------------
    def unify(self, batches: Sequence[DeviceBatch]) -> list[DeviceBatch]:
        """Re-pad all ranks' batches to the step-max shape (SPMD needs one
        global shape; grids are shared across ranks so the per-axis max is
        itself a grid point)."""
        rows = max(b.tokens.shape[0] for b in batches)
        t = max(b.tokens.shape[1] for b in batches)
        out = []
        for b in batches:
            if b.tokens.shape == (rows, t):
                out.append(b)
                continue
            sn, sl = b.tokens.shape
            grown = _zero_batch((rows, t))
            grown.tokens[:sn, :sl] = b.tokens
            grown.positions[:sn, :sl] = b.positions
            grown.segments[:sn, :sl] = b.segments
            grown.loss_mask[:sn, :sl] = b.loss_mask
            grown.lengths[:sn] = b.lengths
            out.append(
                dataclasses.replace(
                    grown, real_samples=b.real_samples, real_tokens=b.real_tokens
                )
            )
        return out


@dataclasses.dataclass(frozen=True)
class DenseLayout(BatchLayout):
    """Right-pad each sample to its own row of the ``(count, len)`` bucket."""

    spec: BucketSpec = dataclasses.field(default_factory=BucketSpec)
    vocab_size: int = 32000
    pad_id: int = 0
    token_fn: object = None

    name = "dense"
    needs_segments = False

    def build(self, group: Group) -> DeviceBatch:
        n_b, l_b = self.spec.bucket_shape(group.size, group.max_length)
        batch = _zero_batch((n_b, l_b))
        if self.pad_id:
            batch.tokens.fill(self.pad_id)
        arange = np.arange(l_b, dtype=np.int32)
        batch.positions[:] = arange  # model default; pads are masked anyway
        for i, sample in enumerate(group.samples):
            ids = sample_token_ids(
                sample, vocab_size=self.vocab_size, token_fn=self.token_fn
            )
            batch.tokens[i, : sample.length] = ids
            batch.segments[i, : sample.length] = 1  # one sample per row
            batch.loss_mask[i, : sample.length] = 1.0
            batch.lengths[i] = sample.length
        return dataclasses.replace(
            batch, real_samples=group.size, real_tokens=group.real_tokens
        )

    def fallback_shape(self) -> tuple[int, int]:
        return self.spec.bucket_shape(1, self.spec.min_len)


@dataclasses.dataclass(frozen=True)
class PackedLayout(BatchLayout):
    """First-fit-decreasing packing into bounded ``(rows, row_capacity)``."""

    spec: PackedBucketSpec = dataclasses.field(default_factory=PackedBucketSpec)
    vocab_size: int = 32000
    pad_id: int = 0
    token_fn: object = None

    name = "packed"
    needs_segments = True

    @staticmethod
    def _first_fit(order: Sequence, cap: int) -> list[list]:
        rows: list[list] = []
        used: list[int] = []
        for sample in order:
            for r, u in enumerate(used):
                if u + sample.length <= cap:
                    rows[r].append(sample)
                    used[r] = u + sample.length
                    break
            else:
                rows.append([sample])
                used.append(sample.length)
        return rows

    @staticmethod
    def _order(group: Group) -> list:
        """Deterministic first-fit-decreasing order (ties break on view_id,
        so checkpoint/resume re-plans the identical packing)."""
        return sorted(group.samples, key=lambda s: (-s.length, s.view_id))

    def plan_rows(self, group: Group) -> tuple[int, list[list]]:
        """Pick (row_capacity, first-fit-decreasing row assignment).

        Every grid capacity that fits the longest sample AND keeps the row
        count within ``max_rows`` is a candidate; the one minimizing the
        bucketed device area wins (ties → the narrowest, which also gives
        the smallest kernel block shapes).
        """
        order = self._order(group)
        best: tuple[int, list[list]] | None = None
        best_area = None
        for cap in self.spec.grid():
            if cap < group.max_length:
                continue
            rows = self._first_fit(order, cap)
            if len(rows) > self.spec.max_rows:
                continue  # narrow cap needs too many rows; wider may fit
            area = self.spec.bucket_rows(len(rows)) * cap
            if best_area is None or area < best_area:
                best, best_area = (cap, rows), area
        if best is None:
            raise ValueError(
                f"group (max_length {group.max_length}, {group.size} samples)"
                f" does not fit the packed grid (max_tokens "
                f"{self.spec.max_tokens}, max_rows {self.spec.max_rows})"
            )
        return best

    def plan_step(
        self, groups: Sequence[Group]
    ) -> tuple[int, int, list[list[list]]]:
        """One (row_capacity, row_count) shared by every rank of a step.

        SPMD forces all ranks onto one batch shape anyway; planning it here
        — minimize ``bucket_rows(max rows over ranks) × cap`` over the grid —
        instead of unifying divergent per-rank plans afterwards means the
        shipped device area is exactly what the planner optimized.
        """
        orders = [self._order(g) for g in groups]
        floor = max(g.max_length for g in groups)
        best = None
        best_area = None
        for cap in self.spec.grid():
            if cap < floor:
                continue
            plans = [self._first_fit(o, cap) for o in orders]
            if max(len(p) for p in plans) > self.spec.max_rows:
                continue
            n_rows = self.spec.bucket_rows(max(len(p) for p in plans))
            area = n_rows * cap
            if best_area is None or area < best_area:
                best, best_area = (cap, n_rows, plans), area
        if best is None:
            raise ValueError(
                f"step (max_length {floor}) does not fit the packed grid "
                f"(max_tokens {self.spec.max_tokens}, "
                f"max_rows {self.spec.max_rows})"
            )
        return best

    def _emit(
        self, group: Group, rows: list[list], shape: tuple[int, int]
    ) -> DeviceBatch:
        batch = _zero_batch(shape)
        if self.pad_id:
            batch.tokens.fill(self.pad_id)
        for r, row in enumerate(rows):
            cursor = 0
            for seg_id, sample in enumerate(row, start=1):
                ids = sample_token_ids(
                    sample, vocab_size=self.vocab_size, token_fn=self.token_fn
                )
                end = cursor + sample.length
                batch.tokens[r, cursor:end] = ids
                batch.segments[r, cursor:end] = seg_id
                batch.positions[r, cursor:end] = np.arange(
                    sample.length, dtype=np.int32
                )
                batch.loss_mask[r, cursor:end] = 1.0
                cursor = end
            batch.lengths[r] = cursor
        return dataclasses.replace(
            batch, real_samples=group.size, real_tokens=group.real_tokens
        )

    def build(self, group: Group) -> DeviceBatch:
        cap, rows = self.plan_rows(group)
        return self._emit(group, rows, (self.spec.bucket_rows(len(rows)), cap))

    def build_step(self, step: Sequence[Group | None]) -> list[DeviceBatch]:
        groups = [g for g in step if g is not None]
        if not groups:
            row = [self.idle_like(self.fallback_shape()) for _ in step]
            _observe_step(self.name, row)
            return row
        cap, n_rows, plans = self.plan_step(groups)
        shape = (n_rows, cap)
        emitted = iter(
            self._emit(g, rows, shape) for g, rows in zip(groups, plans)
        )
        row = [
            self.idle_like(shape) if g is None else next(emitted) for g in step
        ]
        _observe_step(self.name, row)
        return row

    def fallback_shape(self) -> tuple[int, int]:
        return (1, self.spec.min_tokens)


LAYOUTS = ("dense", "packed")


def make_layout(
    name: str,
    *,
    bucket_spec: BucketSpec | None = None,
    packed_spec: PackedBucketSpec | None = None,
    vocab_size: int = 32000,
    token_fn=None,
) -> BatchLayout:
    """Factory from a ``--layout`` name; unknown names fail loudly."""
    if name == "dense":
        return DenseLayout(
            spec=bucket_spec or BucketSpec(),
            vocab_size=vocab_size,
            token_fn=token_fn,
        )
    if name == "packed":
        return PackedLayout(
            spec=packed_spec or PackedBucketSpec(),
            vocab_size=vocab_size,
            token_fn=token_fn,
        )
    raise KeyError(f"unknown batch layout {name!r}; have {LAYOUTS}")


# -----------------------------------------------------------------------------
# Step-level assembly (consumed by the trainer and the device-put stage)
# -----------------------------------------------------------------------------


def unify_step_shapes(
    batches: Sequence[DeviceBatch], layout: BatchLayout | None = None
) -> list[DeviceBatch]:
    """Layout-aware SPMD shape unification across one aligned step."""
    layout = layout or BatchLayout()
    return layout.unify(batches)


def global_batch_arrays(
    batches: Sequence[DeviceBatch], layout: BatchLayout | None = None
) -> dict[str, np.ndarray]:
    """Stack per-rank DeviceBatches into the global (W·rows, T) step arrays.

    A layout that does not need explicit positions/segments in the jitted
    step (dense) gets the lean two-array dict — no point assembling and
    shipping (B, T) int32 arrays the model never reads.
    """
    unified = unify_step_shapes(batches, layout)
    keys = ("tokens", "positions", "segments", "loss_mask")
    if layout is not None and not layout.needs_segments:
        keys = ("tokens", "loss_mask")
    return {
        k: np.concatenate([getattr(b, k) for b in unified], axis=0)
        for k in keys
    }


def device_padding_stats(batches: Sequence[DeviceBatch]) -> dict[str, float]:
    """Aggregate *device-side* padding: occupied slots vs real tokens."""
    real = sum(b.real_tokens for b in batches)
    area = sum(b.area for b in batches)
    return {
        "real_tokens": float(real),
        "device_tokens": float(area),
        "device_padding_fraction": 1.0 - real / area if area else 0.0,
    }
