"""Per-layer metric readers: ``metrics/<name>.py`` for the metric ``name`` of
``BENCHMARK.json``, with ``read(ctx) -> float | None``.  ``ctx`` carries
what a traced run saw (see ``harness.Readings``).  A reader that finds
nothing to read returns None, and the metric is left out of the line."""
