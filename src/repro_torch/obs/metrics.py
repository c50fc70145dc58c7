"""Dependency-free metrics registry (DESIGN.md §13.1).

Three instrument kinds — :class:`Counter` (monotone), :class:`Gauge`
(last-write), :class:`Histogram` (explicit buckets + sum/count) — organized
into named *families* with optional labels, all owned by a
:class:`MetricsRegistry`.  The registry is the single source of truth for
every runtime quantity the repo reports: the admission window, the DGAP
protocol, the batch-layout engine, the trainer step split, the serving
engine and the kernels all write here, and the flat view and the
checkpoint state are *views* of it (the JAX package's Prometheus text
exposition waits for the port's scrape endpoint).

Design constraints (the reason this is hand-rolled rather than a client
library):

  * **cheap when disabled** — a disabled registry hands every caller the one
    shared :data:`NULL` sink whose methods are no-ops: no allocation, no
    lock, no dict; instrumented hot paths (one counter ``inc`` per admitted
    view, per protocol round, per tick) cost a single attribute call;
  * **cheap when enabled** — instruments are plain-slot objects mutated
    without locking on the hot path (CPython attribute stores are atomic;
    cross-thread visibility is all these need).  Only family *creation* and
    snapshotting take the registry lock;
  * **checkpoint-serializable** — ``state()``/``load_state()`` round-trip
    every instrument through plain JSON types, so stream checkpoints carry
    continuous counters across preemption (stream/state.py);
  * **bounded cardinality** — labeled families cap their child count
    (``max_label_children``); past the cap, new label sets get the NULL sink
    and ``obs_dropped_series_total`` counts the drop, so an accidental
    per-request label in serving cannot grow registry memory without bound;
  * **cross-process mergeable** — :class:`CrossProcessAggregator` folds
    ``state()`` dumps shipped by other processes (prefetch workers,
    multi-host windows) into this registry: counters and histograms merge by
    *delta* against the last dump from the same source (so periodic
    re-shipping never double-counts), gauges are last-write-by-timestamp.

Metric names follow the Prometheus convention (``snake_case``, ``_total``
suffix on counters, base units in the name); the stable catalog lives in
DESIGN.md §13.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "NULL",
    "Counter",
    "CrossProcessAggregator",
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

    def load(self, state: dict) -> None:
        self.value = float(state["value"])


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

    def load(self, state: dict) -> None:
        self.value = float(state["value"])


class Histogram:
    """Explicit-bucket histogram: per-bin counts plus running sum/count.

    ``counts[i]`` is the number of observations with
    ``bounds[i-1] < v <= bounds[i]`` (``counts[-1]`` is the +Inf overflow
    bin); the checkpoint state/exposition re-derive the Prometheus *cumulative*
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

    def load(self, state: dict) -> None:
        self.count = int(state["count"])
        self.sum = float(state["sum"])
        # Invert the serialized cumulative form back to per-bin counts.
        cum = state["buckets"]
        previous = 0
        for i, bound in enumerate(self.bounds):
            le = format_float(bound)
            running = int(cum.get(le, previous))
            self.counts[i] = running - previous
            previous = running
        self.counts[-1] = self.count - previous


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
    """Named metric families; flat view, checkpoint state + Prometheus exposition."""

    def __init__(
        self,
        enabled: bool = True,
        max_label_children: int | None = DEFAULT_MAX_LABEL_CHILDREN,
    ) -> None:
        self.enabled = enabled
        # Cardinality budget (DESIGN.md §13): per-family cap on *labeled*
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

    # -- checkpoint round-trip (stream/state.py) -------------------------------
    def state(self, prefix: str | tuple[str, ...] = "") -> dict:
        """JSON-serializable dump of families whose name matches ``prefix``."""
        with self._lock:
            out = {}
            for name, family in self._families.items():
                if prefix and not name.startswith(prefix):
                    continue
                out[name] = {
                    "type": family.kind,
                    "help": family.help,
                    "unit": family.unit,
                    "buckets": list(family.buckets) if family.buckets else None,
                    "children": [
                        [list(map(list, key)), family.children[key].sample()]
                        for key in sorted(family.children)
                    ],
                }
            return out

    def load_state(self, state: dict) -> None:
        """Restore instruments dumped by :meth:`state` (resume path).

        Existing same-name instruments are overwritten — a resumed run
        *continues* the checkpointed counters rather than double-counting.
        """
        if not self.enabled or not state:
            return
        for name, fam_state in state.items():
            buckets = fam_state.get("buckets") or DEFAULT_BUCKETS
            for key_lists, sample in fam_state["children"]:
                labels = {k: v for k, v in key_lists}
                kind = fam_state["type"]
                if kind == "histogram":
                    metric = self.histogram(
                        name, buckets=tuple(buckets),
                        help=fam_state.get("help", ""),
                        unit=fam_state.get("unit", ""), **labels,
                    )
                else:
                    accessor = self.counter if kind == "counter" else self.gauge
                    metric = accessor(
                        name, help=fam_state.get("help", ""),
                        unit=fam_state.get("unit", ""), **labels,
                    )
                metric.load(sample)

    def reset(self) -> None:
        """Drop every family (test isolation)."""
        with self._lock:
            self._families.clear()


class CrossProcessAggregator:
    """Merge ``MetricsRegistry.state()`` dumps from other processes.

    Each producing process (a prefetch worker, a remote host's window) ships
    its *cumulative* registry state periodically, tagged with a source id and
    a wall-clock timestamp.  Merging is idempotent per dump and safe under
    re-shipping:

      * **counters** — the parent counter is incremented by the delta against
        the previous dump from the same source; a value below the previous
        one means the source restarted, so the full new value is the delta;
      * **gauges** — last-write-by-timestamp across all sources (a stale
        worker dump never overwrites a fresher one);
      * **histograms** — per-bin count deltas (plus sum/count deltas) are
        added onto the parent histogram with matching buckets.

    Families whose kinds collide with an existing parent family are skipped
    rather than raising: a misbehaving worker must not take down the trainer.
    """

    def __init__(self, registry: "MetricsRegistry | None" = None) -> None:
        self.registry = registry
        self._counter_last: dict[tuple, float] = {}
        self._hist_last: dict[tuple, dict] = {}
        self._gauge_ts: dict[tuple, float] = {}

    def _target(self) -> "MetricsRegistry":
        return self.registry or default_registry()

    def merge(self, source: str, state: dict, timestamp: float) -> None:
        registry = self._target()
        if not registry.enabled or not state:
            return
        for name, fam_state in state.items():
            kind = fam_state.get("type")
            if kind not in _KINDS:
                continue
            buckets = fam_state.get("buckets")
            for key_lists, sample in fam_state.get("children", []):
                labels = {k: v for k, v in key_lists}
                try:
                    self._merge_child(
                        registry, source, name, kind, buckets, labels,
                        sample, timestamp,
                        help=fam_state.get("help", ""),
                        unit=fam_state.get("unit", ""),
                    )
                except ValueError:
                    # Kind collision with a parent family: skip, don't raise.
                    continue

    def _merge_child(
        self, registry, source, name, kind, buckets, labels, sample,
        timestamp, *, help, unit,
    ) -> None:
        ident = (name, tuple(sorted(labels.items())))
        if kind == "counter":
            metric = registry.counter(name, help=help, unit=unit, **labels)
            last = self._counter_last.get((source, *ident), 0.0)
            value = float(sample["value"])
            delta = value - last if value >= last else value  # restart
            if delta > 0:
                metric.inc(delta)
            self._counter_last[(source, *ident)] = value
        elif kind == "gauge":
            if timestamp >= self._gauge_ts.get(ident, float("-inf")):
                registry.gauge(name, help=help, unit=unit, **labels).set(
                    sample["value"]
                )
                self._gauge_ts[ident] = timestamp
        else:  # histogram
            metric = registry.histogram(
                name, buckets=tuple(buckets or DEFAULT_BUCKETS),
                help=help, unit=unit, **labels,
            )
            if isinstance(metric, NullMetric):
                return
            last = self._hist_last.get(
                (source, *ident), {"count": 0, "sum": 0.0, "buckets": {}}
            )
            if sample["count"] < last["count"]:  # source restarted
                last = {"count": 0, "sum": 0.0, "buckets": {}}
            # Invert both cumulative forms to per-bin counts, add the deltas.
            previous_new = previous_old = 0
            for i, bound in enumerate(metric.bounds):
                le = format_float(bound)
                running_new = int(sample["buckets"].get(le, previous_new))
                running_old = int(last["buckets"].get(le, previous_old))
                metric.counts[i] += (running_new - previous_new) - (
                    running_old - previous_old
                )
                previous_new, previous_old = running_new, running_old
            metric.counts[-1] += (sample["count"] - previous_new) - (
                last["count"] - previous_old
            )
            metric.sum += sample["sum"] - last["sum"]
            metric.count += sample["count"] - last["count"]
            self._hist_last[(source, *ident)] = sample


_DEFAULT = MetricsRegistry(enabled=True)


def default_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented module writes to."""
    return _DEFAULT
