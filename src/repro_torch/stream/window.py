"""Bounded-lookahead admission window, single rank.

A sample's true cost exists only after it is realized, and at most
``lookahead`` realized-but-undelivered samples are resident at any instant:
a ``take`` that would exceed the budget is refused (backpressure by refusal,
never by blocking).  This is the one-rank case of the JAX package's
``BoundedWindow``; its per-rank decomposition, sample quarantine and
multi-host merge are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch import obs
from repro_torch.core.grouping import Sample


@dataclasses.dataclass
class WindowStats:
    """Observability of the admission window (drives tests + benchmarks)."""

    realized: int = 0  # total positions realized
    delivered: int = 0  # total samples handed to the consumer
    peak_resident: int = 0  # max realized-but-undelivered at any instant
    refusals: int = 0  # take() calls throttled by the lookahead budget


class BoundedWindow:
    """Lookahead-bounded realization over a (possibly growing) position order.

    Subclasses define the order: :meth:`order_size` (how many positions exist
    now), :meth:`realize` (pay the realization cost of one position and
    return its :class:`Sample`) and :meth:`order_open` (may more positions
    arrive later?).
    """

    def __init__(self, lookahead: int) -> None:
        if lookahead < 1:
            raise ValueError(f"lookahead must be positive, got {lookahead}")
        self.lookahead = lookahead
        self.cursor = 0
        self.staged: collections.deque[Sample] = collections.deque()
        self.stats = WindowStats()
        self._m_realized = obs.counter(
            "odb_window_realized_total", help="views pushed through realization"
        )
        self._m_delivered = obs.counter(
            "odb_window_delivered_total", help="views handed to the engine"
        )
        self._m_refusals = obs.counter(
            "odb_window_refusals_total",
            help="take() calls throttled by the lookahead budget",
        )
        self._m_resident = obs.gauge(
            "odb_window_resident", help="realized-but-undelivered views resident now"
        )

    # -- order interface (subclass responsibility) -----------------------------
    def order_size(self) -> int:  # pragma: no cover
        raise NotImplementedError

    def realize(self, position: int) -> Sample:  # pragma: no cover
        raise NotImplementedError

    def order_open(self) -> bool:
        return False

    # -- admission -------------------------------------------------------------
    @property
    def resident(self) -> int:
        return len(self.staged)

    def take(self, k: int) -> list[Sample]:
        """Up to ``k`` samples, realizing new positions within the budget."""
        throttled = False
        while len(self.staged) < k and self.cursor < self.order_size():
            if len(self.staged) >= self.lookahead:
                throttled = True
                break
            self.staged.append(self.realize(self.cursor))
            self.cursor += 1
            self.stats.realized += 1
            self.stats.peak_resident = max(self.stats.peak_resident, self.resident)
            self._m_realized.inc()
        if throttled and len(self.staged) < k:
            self.stats.refusals += 1
            self._m_refusals.inc()
        out: list[Sample] = []
        while self.staged and len(out) < k:
            out.append(self.staged.popleft())
        self.stats.delivered += len(out)
        self._m_delivered.inc(len(out))
        self._m_resident.set(self.resident)
        return out

    def exhausted(self) -> bool:
        return not self.order_open() and self.cursor >= self.order_size() and not self.staged

    def remaining(self) -> int:
        """Samples not yet delivered (staged + beyond the cursor)."""
        return len(self.staged) + max(0, self.order_size() - self.cursor)
