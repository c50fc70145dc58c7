"""Observability: metrics registry, span tracer and round audit (stdlib only).

Module-level conveniences operate on the process-wide defaults::

    from repro_torch import obs

    obs.counter("serve_ticks_total").inc()
    with obs.span("serve/tick", tick=3):
        ...
    obs.instant("dgap/closure", event="join_all_finished")

The default registry is enabled; the default tracer is disabled until
``--telemetry DIR`` (or a test) switches it on via :func:`enable_telemetry`;
``--telemetry-port`` serves the registry's Prometheus text while a run goes
on (:func:`start_scrape_server`).
"""

from __future__ import annotations

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    NULL,
    Counter,
    CrossProcessAggregator,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullMetric,
    default_registry,
)
from repro_torch.obs.report import (
    ROUND_DURATION_BUCKETS,
    RoundTimeline,
    RunReporter,
    enable_telemetry,
)
from repro_torch.obs.scrape import ScrapeServer, start_scrape_server
from repro_torch.obs.trace import NULL_SPAN, Span, SpanTracer, default_tracer

__all__ = [
    "DEFAULT_BUCKETS",
    "NULL",
    "NULL_SPAN",
    "ROUND_DURATION_BUCKETS",
    "Counter",
    "CrossProcessAggregator",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullMetric",
    "RoundTimeline",
    "RunReporter",
    "ScrapeServer",
    "Span",
    "SpanTracer",
    "counter",
    "default_registry",
    "default_tracer",
    "enable_telemetry",
    "gauge",
    "histogram",
    "instant",
    "span",
    "start_scrape_server",
]

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
