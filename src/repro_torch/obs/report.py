"""Run reporter: metrics.json / trace.json / DGAP round audit (DESIGN.md §13.3).

Two pieces:

  * :class:`RoundTimeline` — the per-epoch DGAP round audit accumulator the
    streaming executor feeds one entry per protocol round: per-round
    durations, alignment targets, per-rank statuses (from which the
    straggler census is computed), join/non-join closure events and epoch
    aborts.  It is JSON-round-trippable and rides inside stream
    checkpoints, so a resumed run's audit continues the interrupted one
    instead of restarting at zero.
  * :class:`RunReporter` — serializes the registry snapshot
    (``metrics.json``), the Prometheus text (``metrics.prom``), the tracer
    ring (``trace.json``, Chrome trace-event schema) and the round timeline
    (``rounds.json``) into one telemetry directory; ``launch/train.py
    --telemetry DIR`` and ``launch/serve.py --telemetry DIR`` drive it.

Straggler semantics: a rank *straggles* in a round when it reports
"insufficient data" (status 0) while the round still aligned a non-zero
target from the other ranks — exactly the rounds where DGAP's S_min+/C_min+
rule is what keeps the step from stalling on the slow rank.
"""

from __future__ import annotations

import json
import pathlib

from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import SpanTracer, default_tracer

__all__ = ["ROUND_DURATION_BUCKETS", "RoundTimeline", "RunReporter", "enable_telemetry"]

# Protocol rounds are pure-python bookkeeping: microseconds to low
# milliseconds on CPU.  Seconds-scale bins catch pathological stalls.
ROUND_DURATION_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.5, 1.0,
)


class RoundTimeline:
    """Bounded per-epoch DGAP round audit (checkpoint-serializable)."""

    def __init__(self, world_size: int, keep_records: int = 4096) -> None:
        self.world_size = world_size
        self.keep_records = keep_records
        self.rounds = 0
        self.emitted_views = 0
        self.duration_sum_s = 0.0
        self.max_duration_s = 0.0
        # Straggler census: rounds each rank sat at status 0 while the
        # alignment target was non-zero (see module docstring).
        self.straggler_rounds = [0] * world_size
        # Cumulative duration histogram on the shared bucket grid.
        self.duration_buckets = [0] * (len(ROUND_DURATION_BUCKETS) + 1)
        self.closures: list[dict] = []
        # Abort census: one entry per epoch abort, carrying the *full*
        # failed-rank list (a multi-rank stall is the common failure mode on
        # real fabrics; reporting only the first rank hides the blast
        # radius from stream_abort.json and the post-mortem).
        self.aborts: list[dict] = []
        # Rolling window of the most recent per-round records (bounded so a
        # long epoch cannot grow the checkpoint without bound).
        self.records: list[dict] = []
        self.records_dropped = 0

    # -- feeding ---------------------------------------------------------------
    def record_round(self, record, duration_s: float, iteration: int) -> None:
        """Absorb one :class:`repro_torch.core.protocol.RoundRecord`."""
        self.rounds += 1
        self.emitted_views += record.emitted_views
        self.duration_sum_s += duration_s
        self.max_duration_s = max(self.max_duration_s, duration_s)
        bin_idx = 0
        for bound in ROUND_DURATION_BUCKETS:
            if duration_s <= bound:
                break
            bin_idx += 1
        self.duration_buckets[bin_idx] += 1
        if record.target > 0:
            for rank, status in enumerate(record.statuses):
                if rank < self.world_size and status == 0:
                    self.straggler_rounds[rank] += 1
        self.records.append(
            {
                "round": record.round_index,
                "iteration": iteration,
                "duration_s": duration_s,
                "target": record.target,
                "emitted_views": record.emitted_views,
                "statuses": list(record.statuses),
                "potential": record.potential,
            }
        )
        if len(self.records) > self.keep_records:
            del self.records[0]
            self.records_dropped += 1

    def record_closure(self, event: str, iteration: int, rounds: int) -> None:
        """One iteration-termination event (join/non-join/quota crossing)."""
        self.closures.append(
            {"event": event, "iteration": iteration, "iteration_rounds": rounds}
        )

    def record_abort(
        self,
        failed_ranks,
        *,
        round_index: int | None = None,
        attempts: int = 0,
        reason: str = "",
    ) -> None:
        """One epoch abort with its complete straggler casualty list."""
        self.aborts.append(
            {
                "failed_ranks": sorted(set(int(r) for r in failed_ranks)),
                "round_index": round_index,
                "attempts": attempts,
                "reason": reason,
            }
        )

    # -- views / serialization -------------------------------------------------
    def as_dict(self) -> dict:
        hist = {}
        running = 0
        for bound, n in zip(ROUND_DURATION_BUCKETS, self.duration_buckets):
            running += n
            hist[repr(bound)] = running
        hist["+Inf"] = self.rounds
        return {
            "world_size": self.world_size,
            "rounds": self.rounds,
            "emitted_views": self.emitted_views,
            "duration_sum_s": self.duration_sum_s,
            "max_duration_s": self.max_duration_s,
            "straggler_rounds_per_rank": list(self.straggler_rounds),
            "duration_histogram_le": hist,
            "closures": list(self.closures),
            "aborts": list(self.aborts),
            "records": list(self.records),
            "records_dropped": self.records_dropped,
        }

    @classmethod
    def from_dict(cls, state: dict) -> "RoundTimeline":
        timeline = cls(state["world_size"])
        timeline.rounds = state["rounds"]
        timeline.emitted_views = state["emitted_views"]
        timeline.duration_sum_s = state["duration_sum_s"]
        timeline.max_duration_s = state["max_duration_s"]
        timeline.straggler_rounds = list(state["straggler_rounds_per_rank"])
        # Invert the cumulative serialized form back to per-bin counts.
        cum = state["duration_histogram_le"]
        previous = 0
        for i, bound in enumerate(ROUND_DURATION_BUCKETS):
            running = int(cum.get(repr(bound), previous))
            timeline.duration_buckets[i] = running - previous
            previous = running
        timeline.duration_buckets[-1] = timeline.rounds - previous
        timeline.closures = list(state["closures"])
        timeline.aborts = list(state.get("aborts", []))
        timeline.records = list(state["records"])
        timeline.records_dropped = state.get("records_dropped", 0)
        return timeline


class RunReporter:
    """Serialize one run's telemetry into ``<dir>/{metrics,trace,rounds}.json``."""

    def __init__(
        self,
        out_dir,
        registry: MetricsRegistry | None = None,
        tracer: SpanTracer | None = None,
    ) -> None:
        self.out_dir = pathlib.Path(out_dir)
        self.registry = registry if registry is not None else default_registry()
        self.tracer = tracer if tracer is not None else default_tracer()

    def _write_json(self, name: str, payload: dict) -> pathlib.Path:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / name
        path.write_text(json.dumps(payload, indent=1, sort_keys=True))
        return path

    def write_metrics(self, extra: dict | None = None) -> pathlib.Path:
        """``metrics.json``: the flat view (CI keys) + the full snapshot."""
        payload = {
            "flat": self.registry.flat(),
            "families": self.registry.snapshot(),
        }
        if extra:
            payload["run"] = extra
        return self._write_json("metrics.json", payload)

    def write_prometheus(self) -> pathlib.Path:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "metrics.prom"
        path.write_text(self.registry.prometheus_text())
        return path

    def write_trace(self) -> pathlib.Path:
        return self.tracer.write(self.out_dir / "trace.json")

    def write_rounds(self, round_audit: "RoundTimeline | dict") -> pathlib.Path:
        if isinstance(round_audit, RoundTimeline):
            round_audit = round_audit.as_dict()
        return self._write_json("rounds.json", round_audit)

    def write(
        self,
        round_audit: "RoundTimeline | dict | None" = None,
        extra: dict | None = None,
    ) -> dict[str, str]:
        """Emit every artifact; returns name → path written."""
        paths = {
            "metrics": str(self.write_metrics(extra)),
            "prometheus": str(self.write_prometheus()),
            "trace": str(self.write_trace()),
        }
        if round_audit is not None:
            paths["rounds"] = str(self.write_rounds(round_audit))
        return paths


def enable_telemetry(
    out_dir,
    registry: MetricsRegistry | None = None,
    tracer: SpanTracer | None = None,
) -> RunReporter:
    """Switch the (default) registry + tracer on and return a reporter.

    The one call a launcher makes for ``--telemetry DIR`` — before building
    the instrumented objects, so construction-time cached instruments bind
    to live metrics rather than the disabled-mode null sink.
    """
    reporter = RunReporter(out_dir, registry=registry, tracer=tracer)
    reporter.registry.enable()
    reporter.tracer.enable()
    return reporter
