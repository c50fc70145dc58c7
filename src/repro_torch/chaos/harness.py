"""Chaos scenarios: seeded fault plans driven end-to-end through the runtime.

Each scenario builds a small streaming epoch, injects exactly one fault
class from a :class:`ChaosPlan`, and checks the §15 acceptance rails:

  * **bounded termination** — the run finishes (or aborts into a resumable
    checkpoint); protocol rounds stay inside the Theorem-4 envelope, so a
    fault can degrade throughput but never produce an unbounded epoch;
  * **bit-exactness or full accounting** — the recovered step stream is
    identical to the fault-free one (transient faults, worker kills,
    abort/resume), or the divergence is exactly the quarantined component X
    and the epoch audit accounts for every view
    (``EpochAudit.coverage_accounted``).

Scenarios are pure functions of ``seed`` — no wall-clock randomness — so a
failing seed is a complete reproduction recipe.  ``chip_smoke.py`` runs the
matrix on the card's host, and ``tests/test_torch_chaos.py`` holds every
result and digest against the JAX package's harness.

The scenarios are the JAX package's, over this package's verbatim copies of
the executor, window, pipeline and worker pool; only the checkpoint scenario
differs in form: the port's checkpoints take tensors and restore in place.
"""

from __future__ import annotations

import dataclasses
import hashlib
import tempfile
import time
import warnings

from repro_torch.chaos.inject import (
    CollectiveInjector,
    make_worker_killer,
    poison_samples,
    truncate_file,
)
from repro_torch.chaos.plan import ChaosPlan, unit_hash
from repro_torch.core.buckets import BucketSpec
from repro_torch.core.layout import make_layout
from repro_torch.core.protocol import IDLE, OdbConfig
from repro_torch.data.pipeline import PipelinePolicy, RawRecord
from repro_torch.stream.executor import EpochAborted, StreamExecutor
from repro_torch.stream.state import StreamCheckpoint

WORLD = 4
N_RECORDS = 64
POLICY = PipelinePolicy(cutoff_len=2048)


def make_records(n: int, seed: int) -> list[RawRecord]:
    """Heterogeneous raw records, lengths ~ U[~60, ~900] tokens."""
    return [
        RawRecord(identity=i, chars=int(200 + 3000 * unit_hash("len", seed, i)))
        for i in range(n)
    ]


def base_config(**overrides) -> OdbConfig:
    base = dict(
        l_max=1024,
        # Small buffer + shallow depth so one epoch spans many fetch/drain/
        # emit rounds — chaos sites need a real round structure to land in.
        buffer_size=4,
        prefetch_factor=4,
        num_workers=1,
        # Fast-retry policy for chaos runs: injected faults are simulated, so
        # the only real wall clock spent on a fault is this backoff.
        retry_backoff_s=0.001,
    )
    base.update(overrides)
    return OdbConfig(**base)


def round_bound(executor: StreamExecutor) -> int:
    """Cumulative Theorem-4 envelope over the iterations actually run."""
    per_iteration = (
        executor.spec.per_rank_quota
        + executor.config.depth
        + 64
        + executor.spec.total_views
    )
    return (executor.runner.iteration + 1) * per_iteration


def stream_digest(steps) -> str:
    """Order-sensitive fingerprint of a delivered step stream.

    Hashes the (view_id, identity, length) triple of every sample plus IDLE
    markers, so two streams digest equal iff they deliver the same views in
    the same groups at the same aligned positions.
    """
    h = hashlib.sha256()
    for step in steps:
        for group in step:
            if group is IDLE or group is None:
                h.update(b"|IDLE")
                continue
            for s in group.samples:
                h.update(f"|{s.view_id},{s.identity},{s.length}".encode())
        h.update(b"#")
    return h.hexdigest()


def drain(executor: StreamExecutor) -> list:
    steps = []
    while True:
        step = executor.step()
        if step is None:
            return steps
        steps.append(step)


@dataclasses.dataclass
class ScenarioResult:
    kind: str
    seed: int
    terminated: bool  # finished (or aborted into a checkpoint) — no hang
    within_bound: bool  # protocol rounds inside the Theorem-4 envelope
    rounds: int
    bound: int
    bit_exact: bool  # recovered stream == fault-free stream
    accounted: bool  # divergence fully captured by the (R,Q,B,E,X) audit
    wall_s: float
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return (
            self.terminated
            and self.within_bound
            and (self.bit_exact or self.accounted)
        )

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _baseline(records, config: OdbConfig, seed: int) -> tuple[str, int]:
    """Fault-free digest + step count for the same (records, config, seed)."""
    ex = StreamExecutor(records, POLICY, WORLD, config, seed=seed)
    steps = drain(ex)
    return stream_digest(steps), len(steps)


# -- scenarios ------------------------------------------------------------------


def scenario_gather_delay(seed: int) -> ScenarioResult:
    """Transient deadline misses on random (round, rank) sites.

    Every fault fires on attempt 0 only, so bounded retry must recover all
    of them and the delivered stream must be bit-exact the fault-free one.
    """
    records = make_records(N_RECORDS, seed)
    config = base_config(round_deadline_s=0.05, round_retries=2)
    ref_digest, _ = _baseline(records, config, seed)
    plan = ChaosPlan(seed, WORLD)
    injector = CollectiveInjector(
        plan, kind="gather_delay", rate=0.3, max_delay_s=0.2
    )
    t0 = time.perf_counter()
    ex = StreamExecutor(
        records, POLICY, WORLD, config, seed=seed, fault_injector=injector
    )
    steps = drain(ex)
    wall = time.perf_counter() - t0
    return ScenarioResult(
        kind="gather_delay",
        seed=seed,
        terminated=True,
        within_bound=ex.runner.rounds <= round_bound(ex),
        rounds=ex.runner.rounds,
        bound=round_bound(ex),
        bit_exact=stream_digest(steps) == ref_digest,
        accounted=ex.audit().coverage_accounted,
        wall_s=wall,
        details={"injected": injector.injected, "steps": len(steps)},
    )


def scenario_gather_drop(seed: int) -> ScenarioResult:
    """Hard payload loss: abort -> checkpoint round-trip -> resume -> bit-exact.

    One rank's payload drops on every attempt at a planned round, so the
    retry budget exhausts and the executor must abort into a *valid* stream
    checkpoint.  Resuming (fault cleared — the rank "came back") replays the
    aborted round; the combined pre-abort + post-resume stream must equal
    the uninterrupted fault-free stream.
    """
    records = make_records(N_RECORDS, seed)
    config = base_config(round_deadline_s=0.05, round_retries=1)
    ref_digest, ref_steps = _baseline(records, config, seed)
    plan = ChaosPlan(seed, WORLD)
    # Rounds 1..3 always exist (depth 4 << per-rank quota 16 forces several
    # fetch rounds), so the planned outage is guaranteed to fire.
    injector = CollectiveInjector(
        plan, kind="gather_drop", at_round=1 + int(unit_hash("drop-at", seed) * 3)
    )
    t0 = time.perf_counter()
    ex = StreamExecutor(
        records, POLICY, WORLD, config, seed=seed, fault_injector=injector
    )
    steps = []  # pre-abort prefix accumulates here, then the resumed suffix
    aborted = False
    try:
        while True:
            step = ex.step()
            if step is None:
                break
            steps.append(step)
    except EpochAborted as exc:
        aborted = True
        # Full degraded-mode path: serialize, reparse, resume clean (the
        # "rank came back" recovery — no injector on the resumed executor).
        ck = StreamCheckpoint.from_json(exc.checkpoint().to_json())
        resumed = StreamExecutor.resume(ck, records, POLICY)
        steps += drain(resumed)
        ex = resumed
    wall = time.perf_counter() - t0
    return ScenarioResult(
        kind="gather_drop",
        seed=seed,
        terminated=True,
        within_bound=ex.runner.rounds <= round_bound(ex),
        rounds=ex.runner.rounds,
        bound=round_bound(ex),
        bit_exact=stream_digest(steps) == ref_digest,
        accounted=ex.audit().coverage_accounted,
        wall_s=wall,
        details={
            "aborted": aborted,
            "injected": injector.injected,
            "steps": len(steps),
            "ref_steps": ref_steps,
        },
    )


def scenario_slow_rank(seed: int) -> ScenarioResult:
    """Persistent sub-deadline straggler: no faults, no retries, bit-exact."""
    records = make_records(N_RECORDS, seed)
    config = base_config(round_deadline_s=0.05, round_retries=2)
    ref_digest, _ = _baseline(records, config, seed)
    plan = ChaosPlan(seed, WORLD)
    injector = CollectiveInjector(
        plan,
        kind="slow_rank",
        max_delay_s=0.01,  # late, but inside the deadline: never a fault
        slow_rank=int(unit_hash("slow", seed) * WORLD),
    )
    t0 = time.perf_counter()
    ex = StreamExecutor(
        records, POLICY, WORLD, config, seed=seed, fault_injector=injector
    )
    steps = drain(ex)
    wall = time.perf_counter() - t0
    return ScenarioResult(
        kind="slow_rank",
        seed=seed,
        terminated=True,
        within_bound=ex.runner.rounds <= round_bound(ex),
        rounds=ex.runner.rounds,
        bound=round_bound(ex),
        bit_exact=stream_digest(steps) == ref_digest,
        accounted=ex.audit().coverage_accounted,
        wall_s=wall,
        details={"injected": injector.injected, "steps": len(steps)},
    )


def scenario_poison_sample(seed: int) -> ScenarioResult:
    """Poison samples -> quarantine component X, surviving checkpoint/resume.

    Three identities fail realization every time they are touched.  With a
    quarantine budget the epoch must complete, the audit must account every
    view as emitted-or-quarantined, and a mid-run checkpoint/resume must
    preserve the quarantine ledger exactly.
    """
    records = make_records(N_RECORDS, seed)
    plan = ChaosPlan(seed, WORLD)
    poison = plan.poison_identities(N_RECORDS, count=3)
    config = base_config(max_quarantine=len(poison))
    t0 = time.perf_counter()
    with poison_samples(poison):
        ex = StreamExecutor(records, POLICY, WORLD, config, seed=seed)
        steps = []
        for _ in range(3):  # deliver a prefix, then checkpoint mid-epoch
            step = ex.step()
            if step is None:
                break
            steps.append(step)
        ck = StreamCheckpoint.from_json(ex.checkpoint().to_json())
        resumed = StreamExecutor.resume(ck, records, POLICY)
        ledger_preserved = (
            resumed.runner.quarantined_ids == ex.runner.quarantined_ids
            and resumed.runner.quarantined_views == ex.runner.quarantined_views
        )
        steps += drain(resumed)
    wall = time.perf_counter() - t0
    audit = resumed.audit()
    quarantine_exact = (
        set(resumed.runner.quarantined_ids) <= set(poison)
        and audit.quarantined_identities == len(poison)
    )
    return ScenarioResult(
        kind="poison_sample",
        seed=seed,
        terminated=True,
        within_bound=resumed.runner.rounds <= round_bound(resumed),
        rounds=resumed.runner.rounds,
        bound=round_bound(resumed),
        bit_exact=False,  # the stream legitimately lacks the poison views
        accounted=(
            audit.coverage_accounted and ledger_preserved and quarantine_exact
        ),
        wall_s=wall,
        details={
            "poison": sorted(poison),
            "quarantined_views": resumed.runner.quarantined_views,
            "steps": len(steps),
        },
    )


def scenario_worker_kill(seed: int) -> ScenarioResult:
    """SIGKILL all realization workers at a planned submission: ordered,
    bit-exact.

    The pool must reclaim every claimed task in-process and finish the epoch
    degraded; the delivered step stream (submission order == delivery order)
    must match the in-process fault-free stream exactly.
    """
    from repro_torch.stream.workers import WorkerPool

    records = make_records(N_RECORDS, seed)
    config = base_config()
    ref = StreamExecutor(records, POLICY, WORLD, config, seed=seed)
    ref_steps = drain(ref)
    plan = ChaosPlan(seed, WORLD)
    layout = make_layout(
        "dense",
        bucket_spec=BucketSpec(min_len=128, max_len=2048, max_count=64),
        vocab_size=128,
    )
    killer = make_worker_killer(plan.kill_seq(len(ref_steps)))
    t0 = time.perf_counter()
    ex = StreamExecutor(records, POLICY, WORLD, config, seed=seed)
    got = []
    with warnings.catch_warnings():
        # Worker loss legitimately warns (RuntimeWarning); the rail here is
        # stream integrity, not silence.
        warnings.simplefilter("ignore", RuntimeWarning)
        pool = WorkerPool(layout, 2, fault_hook=killer)
        try:
            done = False
            while True:
                while not done and pool.can_submit():
                    task = ex.next_task()
                    if task is None:
                        done = True
                        break
                    pool.submit(*task)
                if done and not pool.inflight:
                    break
                res = pool.take()
                if res is None:
                    continue
                got.append(res.step)
                if res.release is not None:
                    res.release()
        finally:
            pool.close()
    wall = time.perf_counter() - t0
    return ScenarioResult(
        kind="worker_kill",
        seed=seed,
        terminated=True,
        within_bound=ex.runner.rounds <= round_bound(ex),
        rounds=ex.runner.rounds,
        bound=round_bound(ex),
        bit_exact=stream_digest(got) == stream_digest(ref_steps),
        accounted=ex.audit().coverage_accounted,
        wall_s=wall,
        details={
            "steps": len(got),
            "worker_failures": pool.stats.worker_failures,
            "reexecuted": pool.stats.reexecuted,
        },
    )


def scenario_ckpt_truncate(seed: int) -> ScenarioResult:
    """Torn latest train checkpoint: restore falls back to the previous step.

    The state is CPU tensors; the port's restore copies into the tensors it
    is given, so the fallback shows as step 1's values in ``state_like``.
    """
    import torch

    from repro_torch.train import checkpoint as ckpt

    plan = ChaosPlan(seed, WORLD)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        state_like = {
            "w": torch.zeros((8, 4), dtype=torch.float32),
            "b": torch.zeros((4,), dtype=torch.float32),
        }
        keep = {}
        for step in (1, 2):
            state = {
                "w": torch.full((8, 4), float(step), dtype=torch.float32),
                "b": torch.full((4,), float(10 * step), dtype=torch.float32),
            }
            keep[step] = state
            ckpt.save_checkpoint(tmp, step, state)
        torn = truncate_file(
            f"{tmp}/step_00000002.npz", plan.truncate_fraction()
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            step = ckpt.restore_checkpoint(tmp, state_like)
        exact = step == 1 and all(
            torch.equal(state_like[k], keep[1][k]) for k in state_like
        )
    wall = time.perf_counter() - t0
    return ScenarioResult(
        kind="ckpt_truncate",
        seed=seed,
        terminated=True,
        within_bound=True,
        rounds=0,
        bound=1,
        bit_exact=exact,
        accounted=exact,
        wall_s=wall,
        details={"fallback_step": step, "torn_bytes": torn},
    )


SCENARIOS = {
    "gather_delay": scenario_gather_delay,
    "gather_drop": scenario_gather_drop,
    "slow_rank": scenario_slow_rank,
    "poison_sample": scenario_poison_sample,
    "worker_kill": scenario_worker_kill,
    "ckpt_truncate": scenario_ckpt_truncate,
}


def run_all(seed: int = 0, *, kinds=None) -> dict[str, ScenarioResult]:
    out: dict[str, ScenarioResult] = {}
    for kind in kinds or SCENARIOS:
        out[kind] = SCENARIOS[kind](seed)
    return out
