"""Deterministic chaos-injection harness (DESIGN.md §15.5).

Seeded fault plans (:mod:`repro_torch.chaos.plan`), runtime injectors
(:mod:`repro_torch.chaos.inject`) and end-to-end recovery scenarios with
acceptance rails (:mod:`repro_torch.chaos.harness`): every fault class must
terminate within its envelope, and the recovered stream must be bit-exact
or its divergence fully accounted by the (R, Q, B, E, X) audit.
"""

from repro_torch.chaos.harness import (
    SCENARIOS,
    ScenarioResult,
    run_all,
    stream_digest,
)
from repro_torch.chaos.inject import (
    CollectiveInjector,
    make_worker_killer,
    poison_samples,
    truncate_file,
)
from repro_torch.chaos.plan import FAULT_KINDS, ChaosPlan, unit_hash

__all__ = [
    "FAULT_KINDS",
    "SCENARIOS",
    "ChaosPlan",
    "CollectiveInjector",
    "ScenarioResult",
    "make_worker_killer",
    "poison_samples",
    "run_all",
    "stream_digest",
    "truncate_file",
    "unit_hash",
]
