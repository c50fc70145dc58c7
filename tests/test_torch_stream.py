"""The port's streaming data path against the JAX package's, on the CPU.

Same records on both sides (lengths drawn from a seed with numpy, records
built by each package's own ``_records_from_lengths``), same config, seed,
epoch, lookahead and host count.  Every comparison here is exact: the
stream modules are plain Python and numpy in both packages, so the delivered
steps, arrays, audits, accounting and window stats must be identical.

Wall-clock fields are the one exception, and they are removed before a
checkpoint dict is compared (``_strip_wall_clock``): the round timeline's
durations (``duration_sum_s``, ``max_duration_s``, the duration histogram,
each record's ``duration_s``) and the counter families measured in seconds.
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

from repro import obs as jax_obs
from repro.core import OdbConfig as JaxOdbConfig
from repro.data.datasets import DatasetSpec as JaxDatasetSpec
from repro.data.datasets import _records_from_lengths as jax_records_from_lengths
from repro.data.loader import OnlineDynamicLoader as JaxLoader
from repro.data.pipeline import PipelinePolicy as JaxPolicy
from repro.stream import EpochAborted as JaxEpochAborted
from repro.stream import StreamCheckpoint as JaxCheckpoint
from repro.stream import StreamExecutor as JaxExecutor
from repro_torch import obs
from repro_torch.core import OdbConfig
from repro_torch.core.comm import RankTimeoutError
from repro_torch.core.layout import global_batch_arrays
from repro_torch.data.datasets import DatasetSpec, _records_from_lengths
from repro_torch.data.loader import OnlineDynamicLoader
from repro_torch.data.pipeline import PipelinePolicy
from repro_torch.stream import EpochAborted, StreamCheckpoint, StreamExecutor
from repro_torch.stream.state import step_to_json
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
FIELDS = ("tokens", "positions", "segments", "loss_mask", "lengths")


def _lengths(n: int, seed: int, lo: int = 16, hi: int = 900) -> list[int]:
    return [int(x) for x in np.random.default_rng(seed).integers(lo, hi, size=n)]


def _cfg(join: bool = True, **kw) -> dict:
    return dict(l_max=1024, buffer_size=16, prefetch_factor=8, num_workers=1,
                join_mode=join, **kw)


def _pair(n=150, seed=3, join=True, **cfg_kw):
    """(records, policy, config) for the JAX package and for the port."""
    lengths = _lengths(n, seed)
    return ((jax_records_from_lengths(lengths), JaxPolicy(), JaxOdbConfig(**_cfg(join, **cfg_kw))),
            (_records_from_lengths(lengths), PipelinePolicy(), OdbConfig(**_cfg(join, **cfg_kw))))


def _steps_json(ex, limit=None) -> list:
    """Drive an executor (either package's) and encode its steps as JSON
    triples, so Groups of the two packages compare by value."""
    out = []
    while limit is None or len(out) < limit:
        step = ex.step()
        if step is None:
            break
        out.append(step_to_json(step))
    return out


def _strip_wall_clock(payload: dict) -> dict:
    payload = json.loads(json.dumps(payload))
    rounds = payload["telemetry"]["rounds"]
    for key in ("duration_sum_s", "max_duration_s", "duration_histogram_le"):
        rounds.pop(key)
    for record in rounds["records"]:
        record.pop("duration_s")
    counters = payload["telemetry"]["counters"]
    for name in [n for n in counters if "seconds" in n]:
        counters.pop(name)
    return payload


@pytest.fixture
def fresh_registries():
    """Both packages' default registries emptied, so the odb_* counters a
    checkpoint carries count this test's work only."""
    for reg in (jax_obs.default_registry(), obs.default_registry()):
        reg.reset()
        reg.enable()
    yield
    for reg in (jax_obs.default_registry(), obs.default_registry()):
        reg.reset()


# -- (a) the executor ----------------------------------------------------------------

LOOKAHEADS = {"full": None, "world": WORLD, "quarter": "M/4"}


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("join", [True, False])
@pytest.mark.parametrize("lookahead", list(LOOKAHEADS))
def test_executor_matches_jax(lookahead, join, hosts):
    (jr, jp, jc), (tr, tp, tc) = _pair(join=join)
    la = LOOKAHEADS[lookahead]
    if la == "M/4":
        la = JaxExecutor(jr, jp, WORLD, jc).spec.total_views // 4
    theirs = JaxExecutor(jr, jp, WORLD, jc, seed=5, epoch=1, lookahead=la, num_hosts=hosts)
    ours = StreamExecutor(tr, tp, WORLD, tc, seed=5, epoch=1, lookahead=la, num_hosts=hosts)
    want = _steps_json(theirs)
    assert _steps_json(ours) == want and len(want) > 3
    assert dataclasses.asdict(ours.audit()) == dataclasses.asdict(theirs.audit())
    assert ours.audit().eta_identity == 0.0
    assert dataclasses.asdict(ours.window_stats()) == dataclasses.asdict(theirs.window_stats())
    if la is not None:
        assert ours.window_stats().peak_resident <= la


# -- (b) checkpoints across the two packages ------------------------------------------


@pytest.mark.parametrize("lookahead", [None, 12])
def test_checkpoint_crosses_packages(fresh_registries, lookahead):
    """JAX checkpoints at step k and the port resumes from the JSON (and the
    other way round): the resumed tail equals the uninterrupted JAX run.
    Checkpoints the two take at the same step are equal without their
    wall-clock fields."""
    (jr, jp, jc), (tr, tp, tc) = _pair(n=120, seed=9)
    full = _steps_json(JaxExecutor(jr, jp, WORLD, jc, seed=2, lookahead=lookahead))
    k = len(full) // 2
    for reg in (jax_obs.default_registry(), obs.default_registry()):
        reg.reset()
    theirs = JaxExecutor(jr, jp, WORLD, jc, seed=2, lookahead=lookahead)
    ours = StreamExecutor(tr, tp, WORLD, tc, seed=2, lookahead=lookahead)
    assert _steps_json(theirs, k) == _steps_json(ours, k) == full[:k]
    jax_ck, our_ck = theirs.checkpoint(), ours.checkpoint()
    assert _strip_wall_clock(our_ck.payload) == _strip_wall_clock(jax_ck.payload)

    from_jax = StreamExecutor.resume(StreamCheckpoint.from_json(jax_ck.to_json()), tr, tp)
    assert full[:k] + _steps_json(from_jax) == full
    from_port = JaxExecutor.resume(JaxCheckpoint.from_json(our_ck.to_json()), jr, jp)
    assert full[:k] + _steps_json(from_port) == full
    assert dataclasses.asdict(from_jax.audit()) == dataclasses.asdict(from_port.audit())


def test_checkpoint_version_is_checked():
    (_, _, _), (tr, tp, tc) = _pair(n=40)
    payload = StreamExecutor(tr, tp, 2, tc).checkpoint().payload
    with pytest.raises(ValueError, match="version"):
        StreamCheckpoint.from_json(json.dumps({**payload, "version": 3}))


# -- (c) streaming_epoch ----------------------------------------------------------------

POLICY_KW = dict(cutoff_len=2048)


def _loaders(layout: str, n=60, seed=13, world=2, **cfg_kw):
    lengths = _lengths(n, seed, hi=700)
    jrec, trec = jax_records_from_lengths(lengths), _records_from_lengths(lengths)
    jspec = JaxDatasetSpec("stream-test", n, JaxPolicy(**POLICY_KW), lambda size, s: jrec[:size])
    tspec = DatasetSpec("stream-test", n, PipelinePolicy(**POLICY_KW), lambda size, s: trec[:size])
    kw = dict(layout=layout, seed=3, vocab_size=512)
    return (JaxLoader(jspec, world, JaxOdbConfig(**_cfg(**cfg_kw)), **kw),
            OnlineDynamicLoader(tspec, world, OdbConfig(**_cfg(**cfg_kw)), **kw))


def _digest(steps) -> list:
    """Every array of every rank batch, the metadata and the real counts of
    each step (copied out of any shared-memory slot as it is read)."""
    out = []
    for ls in steps:
        cells = [tuple(getattr(b, f).tobytes() for f in FIELDS) + (b.real_samples, b.real_tokens)
                 for b in ls.batches]
        out.append((dataclasses.asdict(ls.metadata), cells))
    return out


def _assert_same_epoch(ours_loader, theirs_loader, ours, theirs):
    assert ours == theirs and len(ours) > 3
    assert dataclasses.asdict(ours_loader.last_audit) == dataclasses.asdict(theirs_loader.last_audit)
    assert dataclasses.asdict(ours_loader.accounting) == dataclasses.asdict(theirs_loader.accounting)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("lookahead", [None, 8])
def test_streaming_epoch_matches_jax(layout, prefetch, lookahead):
    """Arrays, metadata, accounting and the audit (``rounds`` included:
    both sides stream)."""
    jl, tl = _loaders(layout)
    theirs = _digest(jl.streaming_epoch(0, lookahead=lookahead, prefetch=prefetch))
    ours = _digest(tl.streaming_epoch(0, lookahead=lookahead, prefetch=prefetch))
    _assert_same_epoch(tl, jl, ours, theirs)
    assert (tl.last_prefetch_stats is not None) == prefetch
    if prefetch:
        assert tl.last_prefetch_stats.consumed == len(ours)


@pytest.mark.parametrize("prefetch,num_workers", [(False, 0), (True, 0), (True, 2)])
def test_device_put_on_cpu_stages_the_step_arrays(prefetch, num_workers):
    """``device_put`` on the CPU wraps the global step arrays in CPU tensors
    (no pinning, stream or event); they equal the JAX package's host arrays.
    On the worker path the staging copies out of the ring slot and releases
    it, so only the staged arrays (not the rank batches) are read here."""
    jl, tl = _loaders("packed")
    theirs = list(jl.streaming_epoch(0, prefetch=False))
    ours = list(tl.streaming_epoch(0, prefetch=prefetch, device_put=True, device="cpu",
                                   num_workers=num_workers))
    assert len(ours) == len(theirs) > 3
    for a, b in zip(ours, theirs):
        staged = a.device
        assert staged is not None and staged.event is None and staged.host is None
        want = global_batch_arrays(b.batches, jl.layout)
        assert sorted(staged.arrays) == sorted(want)
        for key, arr in want.items():
            assert staged.arrays[key].device.type == "cpu"
            np.testing.assert_array_equal(staged.arrays[key].numpy(), arr)


def test_prefetch_close_rolls_back_staged_tail():
    """Stopping a prefetched epoch early rolls the producer's staged-but-
    unconsumed steps back into the executor: a checkpoint taken after the
    close resumes at the consumer's frontier, on either package."""
    jl, tl = _loaders("dense", n=80)
    full = _digest(jl.streaming_epoch(0))
    head = []
    it = tl.streaming_epoch(0, prefetch=True, prefetch_depth=3, finalize_audit=False)
    for ls in it:
        head.extend(_digest([ls]))
        if len(head) == 3:
            break
    it.close()
    ck = tl.last_executor.checkpoint()
    assert ck.step_index == 3
    jl2, tl2 = _loaders("dense", n=80)
    tail_port = _digest(tl2.streaming_epoch(resume_from=StreamCheckpoint.from_json(ck.to_json())))
    tail_jax = _digest(jl2.streaming_epoch(resume_from=JaxCheckpoint.from_json(ck.to_json())))
    assert head + tail_port == head + tail_jax == full


def test_finalize_audit_drains_after_early_stop():
    """With ``finalize_audit`` (the default) an early stop still drains the
    data-side schedule, so ``last_audit`` covers the epoch, as in JAX.
    Without it ``last_audit`` covers the rounds run so far; that prefix is
    compared without the prefetch thread, whose run-ahead depends on timing."""
    jl, tl = _loaders("packed")
    for loader in (jl, tl):
        it = loader.streaming_epoch(0, prefetch=True)
        next(it)
        it.close()
    assert dataclasses.asdict(tl.last_audit) == dataclasses.asdict(jl.last_audit)
    assert tl.last_audit.eta_identity == 0.0
    jl2, tl2 = _loaders("packed")
    for loader in (jl2, tl2):
        it = loader.streaming_epoch(0, finalize_audit=False)
        next(it)
        it.close()
    assert dataclasses.asdict(tl2.last_audit) == dataclasses.asdict(jl2.last_audit)
    assert tl2.last_audit.emitted_views < tl.last_audit.emitted_views


# -- (d) the worker processes ---------------------------------------------------------


def test_workers_match_in_process_and_jax():
    """Two spawned workers (with prefetch) deliver the in-process stream bit
    for bit, which is the JAX package's stream; the workers' layout counters
    reach the parent registry."""
    jl, tl = _loaders("packed")
    theirs = _digest(jl.streaming_epoch(0))
    reg = obs.default_registry()
    reg.reset()
    reg.enable()
    ours = _digest(tl.streaming_epoch(0, num_workers=2, prefetch=True))
    _assert_same_epoch(tl, jl, ours, theirs)
    stats = tl.last_worker_stats
    assert stats.completed == stats.submitted == len(ours) and stats.worker_failures == 0
    merged = {name for name in reg.state() if name.startswith("odb_layout_")}
    assert merged, sorted(reg.state())  # layout ran only in the workers
    reg.reset()


def test_sigkilled_workers_tasks_reexecute():
    """Both workers SIGKILLed after the first step: their tasks run again in
    the parent, and the epoch completes in order, bit for bit."""
    import multiprocessing as mp

    jl, tl = _loaders("packed")
    theirs = _digest(jl.streaming_epoch(0))
    ours = []
    with pytest.warns(RuntimeWarning):
        for i, ls in enumerate(tl.streaming_epoch(0, num_workers=2)):
            if i == 0:
                victims = [p for p in mp.active_children() if p.name.startswith("odb-worker-")]
                assert len(victims) == 2
                for p in victims:
                    os.kill(p.pid, signal.SIGKILL)
                for p in victims:
                    p.join(timeout=10)
                    assert not p.is_alive()
            ours.extend(_digest([ls]))
    assert ours == theirs
    assert tl.last_worker_stats.worker_failures == 2 and tl.last_worker_stats.reexecuted > 0


def test_stream_import_leaves_torch_unloaded():
    """What a spawned worker imports: the stream package pulls in the data
    package and the loader, none of which may load torch (or JAX)."""
    code = ("import sys, repro_torch.stream, repro_torch.stream.workers, repro_torch.data; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- (e) an aborted epoch -------------------------------------------------------------


class DropRound:
    """Fault injector: every gather attempt of one round loses rank 1's
    payload (the ``on_gather`` hook of the resilient collective)."""

    def __init__(self, at_round: int) -> None:
        self.at_round = at_round

    def on_gather(self, round_index, attempt, rank, tag):
        return "drop" if (round_index == self.at_round and rank == 1) else None


def test_epoch_aborted_matches_jax_and_resumes():
    (jr, jp, jc), (tr, tp, tc) = _pair(n=100, seed=4, round_retries=1, retry_backoff_s=1e-4)
    full = _steps_json(JaxExecutor(jr, jp, WORLD, jc, seed=1, lookahead=8))
    runs = []
    for cls, records, policy, cfg, aborted in ((JaxExecutor, jr, jp, jc, JaxEpochAborted),
                                                (StreamExecutor, tr, tp, tc, EpochAborted)):
        ex = cls(records, policy, WORLD, cfg, seed=1, lookahead=8, fault_injector=DropRound(10))
        head = []
        with pytest.raises(aborted) as info:
            while (step := ex.step()) is not None:
                head.append(step_to_json(step))
        with pytest.raises(aborted):
            ex.step()  # latched
        runs.append((head, info.value))
    (jhead, jexc), (thead, texc) = runs
    assert thead == jhead and thead == full[:len(thead)] and 0 < len(thead) < len(full)
    assert isinstance(texc.cause, RankTimeoutError)
    assert (texc.cause.round_index, texc.failed_ranks) == (jexc.cause.round_index,
                                                           jexc.failed_ranks) == (10, [1])
    assert texc.checkpoint() is texc.checkpoint()
    # Resume each package from the other's abort checkpoint.
    tail = _steps_json(StreamExecutor.resume(StreamCheckpoint.from_json(
        jexc.checkpoint().to_json()), tr, tp))
    assert thead + tail == full
    tail = _steps_json(JaxExecutor.resume(JaxCheckpoint.from_json(
        texc.checkpoint().to_json()), jr, jp))
    assert jhead + tail == full
