"""Observability: metrics registry and span tracer (stdlib only).

Module-level conveniences operate on the process-wide defaults::

    from repro_torch import obs

    obs.counter("serve_ticks_total").inc()
    with obs.span("serve/tick", tick=3):
        ...
    obs.instant("dgap/closure", event="join_all_finished")

The default registry is enabled; the default tracer is disabled until a
caller enables it.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    NULL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetric,
    default_registry,
)
from repro_torch.obs.trace import NULL_SPAN, Span, SpanTracer, default_tracer

__all__ = [
    "DEFAULT_BUCKETS",
    "NULL",
    "NULL_SPAN",
    "ROUND_DURATION_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullMetric",
    "Span",
    "SpanTracer",
    "counter",
    "default_registry",
    "default_tracer",
    "gauge",
    "histogram",
    "instant",
    "span",
]

# Protocol rounds are pure-python bookkeeping: microseconds to low
# milliseconds on CPU.  Seconds-scale bins catch pathological stalls.
ROUND_DURATION_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.5, 1.0,
)


def counter(name: str, help: str = "", unit: str = "", **labels):
    """Counter from the default registry (NULL sink when disabled)."""
    return default_registry().counter(name, help=help, unit=unit, **labels)


def gauge(name: str, help: str = "", unit: str = "", **labels):
    """Gauge from the default registry (NULL sink when disabled)."""
    return default_registry().gauge(name, help=help, unit=unit, **labels)


def histogram(name: str, buckets=DEFAULT_BUCKETS, help: str = "", unit: str = "", **labels):
    """Histogram from the default registry (NULL sink when disabled)."""
    return default_registry().histogram(name, buckets=buckets, help=help, unit=unit, **labels)


def span(name: str, cat: str = "", **args):
    """Span context manager on the default tracer (NULL_SPAN when disabled)."""
    return default_tracer().span(name, cat=cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    """Instant event on the default tracer (no-op when disabled)."""
    default_tracer().instant(name, cat=cat, **args)
