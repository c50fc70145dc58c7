"""Dependency-free metrics registry (copy of the JAX package's, minus the
checkpoint round-trip, the Prometheus exposition and the cross-process
aggregator, which serving does not use yet).

Three instrument kinds — :class:`Counter` (monotone), :class:`Gauge`
(last-write), :class:`Histogram` (explicit buckets + sum/count) — organized
into named families with optional labels.  A disabled registry hands every
caller the one shared :data:`NULL` sink, so instrumented hot paths cost one
attribute call; labeled families cap their child count, and past the cap new
label sets get the NULL sink and ``obs_dropped_series_total`` counts the drop.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "NULL",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullMetric",
    "default_registry",
]

#: Family name of the cardinality-budget drop counter (itself unlabeled, so
#: it can never be the victim of the cap it enforces).
DROPPED_SERIES = "obs_dropped_series_total"

#: Default per-family labeled-child budget.  Generous for every legitimate
#: label in the catalog (layout names, worker ids, shape cells) while
#: bounding the damage of an accidental per-request label.
DEFAULT_MAX_LABEL_CHILDREN = 256

# Generic latency buckets (seconds) — callers with tighter distributions
# (protocol rounds, TTFT) pass their own explicit grids.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class NullMetric:
    """The shared no-op sink a disabled registry returns (zero allocation)."""

    __slots__ = ()

    def inc(self, amount: float = 1) -> None:
        pass

    def dec(self, amount: float = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0


NULL = NullMetric()


class Counter:
    """Monotonically increasing count (float increments allowed: seconds)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount

    def sample(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1) -> None:
        self.value += amount

    def dec(self, amount: float = 1) -> None:
        self.value -= amount

    def sample(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Explicit-bucket histogram: per-bin counts plus running sum/count.

    ``counts[i]`` is the number of observations with
    ``bounds[i-1] < v <= bounds[i]`` (``counts[-1]`` is the +Inf overflow
    bin); :meth:`cumulative` re-derives the Prometheus *cumulative*
    ``le`` form from these.
    """

    __slots__ = ("bounds", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, buckets=DEFAULT_BUCKETS) -> None:
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"buckets must be strictly increasing: {buckets}")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> list[tuple[str, int]]:
        """Prometheus-style (le, cumulative count) pairs ending at +Inf."""
        out = []
        running = 0
        for bound, n in zip(self.bounds, self.counts):
            running += n
            out.append((format_float(bound), running))
        out.append(("+Inf", self.count))
        return out

    def sample(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "buckets": {le: n for le, n in self.cumulative()},
        }


def format_float(v: float) -> str:
    """Canonical bucket-bound / label rendering (no trailing zeros)."""
    return repr(int(v)) if float(v).is_integer() else repr(v)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric plus its labeled children."""

    def __init__(self, name: str, kind: str, help: str, unit: str, buckets) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.buckets = buckets
        self.children: dict[tuple[tuple[str, str], ...], object] = {}

    def child(self, labels: tuple[tuple[str, str], ...]):
        metric = self.children.get(labels)
        if metric is None:
            cls = _KINDS[self.kind]
            metric = cls(self.buckets) if self.kind == "histogram" else cls()
            self.children[labels] = metric
        return metric


def _label_key(labels: dict) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_suffix(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Named metric families with a flat ``name{labels} -> value`` view."""

    def __init__(
        self,
        enabled: bool = True,
        max_label_children: int | None = DEFAULT_MAX_LABEL_CHILDREN,
    ) -> None:
        self.enabled = enabled
        # Cardinality budget: per-family cap on *labeled*
        # children; None = unbounded.  The unlabeled child is always allowed.
        self.max_label_children = max_label_children
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    # -- enablement ------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        """Hand out :data:`NULL` from now on; existing instruments keep their
        values (re-enable to resume recording through fresh lookups)."""
        self.enabled = False

    # -- instrument accessors --------------------------------------------------
    def _get(self, name: str, kind: str, help: str, unit: str, buckets, labels):
        if not self.enabled:
            return NULL
        with self._lock:
            family = self._families.get(name)
            if family is None:
                family = MetricFamily(name, kind, help, unit, buckets)
                self._families[name] = family
            elif family.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {family.kind}, "
                    f"requested {kind}"
                )
            key = _label_key(labels)
            if (
                key
                and self.max_label_children is not None
                and key not in family.children
                and sum(1 for k in family.children if k) >= self.max_label_children
            ):
                # Over budget: this label set never materializes.  Count the
                # drop on the (unlabeled, hence uncappable) drop counter.
                dropped = self._families.get(DROPPED_SERIES)
                if dropped is None:
                    dropped = MetricFamily(
                        DROPPED_SERIES, "counter",
                        "label sets refused by the per-family cardinality cap",
                        "", None,
                    )
                    self._families[DROPPED_SERIES] = dropped
                dropped.child(()).inc()
                return NULL
            return family.child(key)

    def counter(self, name: str, help: str = "", unit: str = "", **labels):
        return self._get(name, "counter", help, unit, None, labels)

    def gauge(self, name: str, help: str = "", unit: str = "", **labels):
        return self._get(name, "gauge", help, unit, None, labels)

    def histogram(
        self, name: str, buckets=DEFAULT_BUCKETS, help: str = "",
        unit: str = "", **labels,
    ):
        return self._get(name, "histogram", help, unit, buckets, labels)

    # -- views -----------------------------------------------------------------
    def flat(self) -> dict[str, float]:
        """Flat ``name{labels} -> value`` view (CI checks, log lines).

        Histograms flatten to ``<name>_count`` and ``<name>_sum``.
        """
        out: dict[str, float] = {}
        with self._lock:
            for name in sorted(self._families):
                family = self._families[name]
                for key in sorted(family.children):
                    metric = family.children[key]
                    suffix = _label_suffix(key)
                    if family.kind == "histogram":
                        out[f"{name}_count{suffix}"] = metric.count
                        out[f"{name}_sum{suffix}"] = metric.sum
                    else:
                        out[f"{name}{suffix}"] = metric.value
        return out

    def reset(self) -> None:
        """Drop every family (test isolation)."""
        with self._lock:
            self._families.clear()


_DEFAULT = MetricsRegistry(enabled=True)


def default_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented module writes to."""
    return _DEFAULT
