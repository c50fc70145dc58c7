"""Serving shape cells (the ``ServeCell`` part of the JAX package's shapes)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """Shape contract of one continuous-batching serve deployment.

    ``num_slots`` fixes the decode batch rows (= KV-cache slots); ``max_len``
    the per-slot cache capacity; ``l_max`` the shared admission token budget
    (the Eq.-1 knob reused from training).  The packed prefill stream is
    bucketed separately (``PackedBucketSpec`` grid in the engine config), so
    the step census is: exactly one decode shape + one prefill shape per
    occupied (rows, capacity) bucket.
    """

    name: str
    num_slots: int
    max_len: int
    l_max: int
