"""The port's chaos harness against the JAX package's, on the CPU.

Both harnesses drive the same scenarios over their own (verbatim) copies of
the executor, window, pipeline and worker pool, so every rail, round count,
bound and digest must be identical.  Two fields are not compared for
equality: ``wall_s`` (wall clock), and ``worker_kill``'s ``reexecuted``,
the count of tasks the workers had claimed when they were killed, which
depends on how far they got before the SIGKILL (it varies between runs of
either package); it is held to its bounds instead.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

from repro.chaos import harness as jax_harness
from repro.chaos import inject as jax_inject
from repro.chaos.plan import ChaosPlan as JaxPlan
from repro.chaos.plan import unit_hash as jax_unit_hash
from repro.data import pipeline as jax_pipeline
from repro_torch import obs
from repro_torch.chaos import (
    FAULT_KINDS,
    SCENARIOS,
    ChaosPlan,
    CollectiveInjector,
    poison_samples,
    run_all,
    stream_digest,
    truncate_file,
    unit_hash,
)
from repro_torch.chaos import harness
from repro_torch.data import pipeline
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

SEEDS = (0, 1, 2)
RACY = {"worker_kill": ("reexecuted",)}  # details that depend on thread/process timing


def _comparable(res) -> dict:
    d = dataclasses.asdict(res)
    d.pop("wall_s")
    d["details"] = {k: v for k, v in d["details"].items() if k not in RACY.get(res.kind, ())}
    d["ok"] = res.ok
    return d


def test_fault_kinds_and_scenarios_match_jax():
    assert tuple(SCENARIOS) == tuple(jax_harness.SCENARIOS) == FAULT_KINDS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_scenario_matches_jax(kind, seed):
    ours = SCENARIOS[kind](seed)
    theirs = jax_harness.SCENARIOS[kind](seed)
    assert _comparable(ours) == _comparable(theirs)
    # The rails of tests/test_faults.py, on the port's result.
    assert ours.terminated and ours.within_bound and ours.ok, ours.as_dict()
    if kind == "gather_drop":
        assert ours.details["aborted"]
    if kind == "poison_sample":
        assert not ours.bit_exact and ours.accounted
    else:
        assert ours.bit_exact
    if kind == "worker_kill":
        assert 1 <= ours.details["reexecuted"] <= ours.details["steps"]
        assert ours.details["worker_failures"] == 2


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_free_baseline_digest_matches_jax(seed):
    """The fault-free stream of every stream scenario: the same records, the
    same steps and the same ``stream_digest`` string in both packages, and
    each package's digest function agrees on the other's steps."""
    records = harness.make_records(harness.N_RECORDS, seed)
    jax_records = jax_harness.make_records(jax_harness.N_RECORDS, seed)
    assert [(r.identity, r.chars) for r in records] == [
        (r.identity, r.chars) for r in jax_records]
    for overrides in ({}, dict(round_deadline_s=0.05, round_retries=2),
                      dict(round_deadline_s=0.05, round_retries=1)):
        ours = harness._baseline(records, harness.base_config(**overrides), seed)
        theirs = jax_harness._baseline(jax_records, jax_harness.base_config(**overrides), seed)
        assert ours == theirs
        assert len(ours[0]) == 64
    steps = harness.drain(harness.StreamExecutor(
        records, harness.POLICY, harness.WORLD, harness.base_config(), seed=seed))
    assert jax_harness.stream_digest(steps) == stream_digest(steps)


def test_run_all_subset():
    out = run_all(0, kinds=("slow_rank", "ckpt_truncate"))
    assert list(out) == ["slow_rank", "ckpt_truncate"]
    assert all(r.ok and r.bit_exact for r in out.values())
    assert out["ckpt_truncate"].details["fallback_step"] == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_decisions_match_jax(seed):
    ours, theirs = ChaosPlan(seed, 4), JaxPlan(seed, 4)
    for rnd in range(24):
        for rank in range(4):
            for rate in (0.0, 0.3, 1.0):
                assert ours.delay(rnd, rank, rate=rate, max_delay_s=0.2) == theirs.delay(
                    rnd, rank, rate=rate, max_delay_s=0.2)
                assert ours.drop(rnd, rank, rate=rate) == theirs.drop(rnd, rank, rate=rate)
    for n, count in ((64, 3), (10, 20), (0, 2)):
        assert ours.poison_identities(n, count=count) == theirs.poison_identities(n, count=count)
    for total in (-1, 0, 1, 17, 64):
        assert ours.kill_seq(total) == theirs.kill_seq(total)
    assert ours.truncate_fraction() == theirs.truncate_fraction()
    assert 0.3 <= ours.truncate_fraction() < 0.9
    parts = [("len", seed, i) for i in range(16)] + [("drop-at", seed), ("slow", seed)]
    assert [unit_hash(*p) for p in parts] == [jax_unit_hash(*p) for p in parts]


SITES = [(rnd, attempt, rank, tag) for rnd in range(12) for attempt in range(3)
         for rank in range(4) for tag in ("primary", "secondary")]


def _fault_sequence(injector) -> list:
    return [injector.on_gather(*site) for site in SITES] + [injector.injected]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [
    dict(kind="gather_delay", rate=0.3, max_delay_s=0.2),
    dict(kind="gather_drop", rate=0.2),
    dict(kind="gather_drop", at_round=2),
    dict(kind="slow_rank", max_delay_s=0.01, slow_rank=3),
], ids=["delay", "drop-rate", "drop-at", "slow"])
def test_collective_injector_matches_jax(kw, seed):
    ours = CollectiveInjector(ChaosPlan(seed, 4), **kw)
    theirs = jax_inject.CollectiveInjector(JaxPlan(seed, 4), **kw)
    got = _fault_sequence(ours)
    assert got == _fault_sequence(theirs)
    assert got[-1] > 0  # every configuration above fires somewhere in the grid
    if kw["kind"] == "gather_delay":  # transient: attempt 0 only
        assert all(f is None for f, site in zip(got, SITES) if site[1] > 0)


def test_collective_injector_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective fault kind"):
        CollectiveInjector(ChaosPlan(0, 4), kind="poison_sample")


def test_injections_are_counted_in_the_ports_registry():
    counter = obs.counter("odb_fault_injected_total", kind="slow_rank")
    before = counter.value
    inj = CollectiveInjector(ChaosPlan(0, 2), kind="slow_rank", max_delay_s=0.01, slow_rank=1)
    assert inj.on_gather(0, 0, 1, "primary") == 0.01
    assert inj.on_gather(0, 0, 0, "primary") is None
    assert counter.value == before + 1


def test_poison_samples_matches_jax_and_restores_the_hook():
    policy = pipeline.PipelinePolicy(cutoff_len=2048)
    jax_policy = jax_pipeline.PipelinePolicy(cutoff_len=2048)
    records = harness.make_records(16, 0)
    poison = ChaosPlan(0, 4).poison_identities(16, count=3)
    previous = pipeline.set_pipeline_fault_hook(None)
    try:
        with poison_samples(poison), jax_inject.poison_samples(poison):
            for rec in records:
                jax_rec = jax_pipeline.RawRecord(identity=rec.identity, chars=rec.chars)
                if rec.identity in poison:
                    with pytest.raises(pipeline.SampleCorruptionError):
                        pipeline.run_pipeline(rec, policy)
                    with pytest.raises(jax_pipeline.SampleCorruptionError):
                        jax_pipeline.run_pipeline(jax_rec, jax_policy)
                else:
                    assert pipeline.run_pipeline(rec, policy) == jax_pipeline.run_pipeline(
                        jax_rec, jax_policy)
        assert pipeline.set_pipeline_fault_hook(None) is None
    finally:
        pipeline.set_pipeline_fault_hook(previous)


@pytest.mark.parametrize("fraction", [-0.5, 0.0, 0.37, 0.9, 1.5])
def test_truncate_file_matches_jax(fraction):
    data = np.random.default_rng(5).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        for p in (a, b):
            with open(p, "wb") as f:
                f.write(data)
        keep = truncate_file(a, fraction)
        assert keep == jax_inject.truncate_file(b, fraction)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read() == data[:keep]
