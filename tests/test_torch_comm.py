"""The port's rank-driven collective against the JAX package, on the CPU.

The int64 wire codec equals JAX's element for element over a sweep of
payloads (mirroring tests/test_comm.py's codec cases); ``TorchProcessCollective``
gathers at world 1 in this process and over two spawned gloo ranks
(``tests/_torch_rank_worker.py``); a peer out of lockstep raises
``ProtocolDesyncError`` on every rank and the per-tag audit holds; a rank
that never calls surfaces ``RankTimeoutError`` by the deadline, without a
retry and without a hang; an injected drop is retried as in JAX.
"""

import datetime
import multiprocessing as mp
import pickle

import numpy as np
import pytest
import torch.distributed as dist

from repro.core import comm as jax_comm
from repro_torch.core.comm import (
    ProtocolDesyncError,
    RankTimeoutError,
    ResilientCollective,
    TorchProcessCollective,
    decode_round_payload,
    encode_round_payload,
    round_payload_length,
)

import _torch_rank_worker
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

WINDOW = {"host": 1, "cursor": 9, "staged": 2, "delivered": 7, "resident": 5,
          "quarantined_ids": [3, 42]}
PAYLOAD = {"idx_budget": 17, "n_groups": 2, "sizes": [4, 3], "tokens": [900, 512],
           "window": WINDOW}

# (payload, group capacity, quarantine capacity)
CODEC_CASES = {
    "window": (PAYLOAD, 4, 4),
    "no-window": ({k: v for k, v in PAYLOAD.items() if k != "window"}, 4, 0),
    "negative-status": ({"idx_budget": 0, "n_groups": -1, "sizes": [], "tokens": []}, 2, 0),
    "full-capacity": ({"idx_budget": 2**40, "n_groups": 3, "sizes": [1, 2, 3],
                       "tokens": [7, 8, 2**33]}, 3, 0),
    "empty-quarantine": ({**PAYLOAD, "window": {**WINDOW, "quarantined_ids": []}}, 2, 3),
    "window-defaults": ({**PAYLOAD, "window": {"quarantined_ids": [0]}}, 2, 1),
}


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_wire_codec_equals_jax(name):
    payload, cap, qcap = CODEC_CASES[name]
    vec = encode_round_payload(payload, group_capacity=cap, quarantine_capacity=qcap)
    ref = jax_comm.encode_round_payload(payload, group_capacity=cap, quarantine_capacity=qcap)
    assert vec.dtype == np.int64 and len(vec) == round_payload_length(cap, qcap)
    np.testing.assert_array_equal(vec, ref)
    out = decode_round_payload(vec, group_capacity=cap, quarantine_capacity=qcap)
    assert out == jax_comm.decode_round_payload(ref, group_capacity=cap, quarantine_capacity=qcap)
    assert round_payload_length(cap, qcap) == jax_comm.round_payload_length(cap, qcap)


@pytest.mark.parametrize("case", [
    (dict(group_capacity=1), "exceed wire capacity"),
    (dict(group_capacity=4, quarantine_capacity=1), "quarantined ids"),
])
def test_wire_codec_overflow_raises_as_jax(case):
    kwargs, match = case
    for encode in (encode_round_payload, jax_comm.encode_round_payload):
        with pytest.raises(ValueError, match=match):
            encode(PAYLOAD, **kwargs)


def test_wire_codec_length_mismatch_raises():
    vec = encode_round_payload(PAYLOAD, group_capacity=4, quarantine_capacity=4)
    with pytest.raises(ValueError, match="length"):
        decode_round_payload(vec, group_capacity=5, quarantine_capacity=4)


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=20))
    try:
        yield TorchProcessCollective(1)
    finally:
        dist.destroy_process_group()


def test_process_collective_world1(world1):
    vec = encode_round_payload(PAYLOAD, group_capacity=4, quarantine_capacity=4)
    out = world1.all_gather(0, vec)
    assert len(out) == 1 and out[0].dtype == np.int64
    assert decode_round_payload(out[0], group_capacity=4, quarantine_capacity=4) == PAYLOAD
    assert world1.stats.rounds == 1 and world1.calls_per_tag == {"primary": 1}
    with pytest.raises(ValueError, match="rank 1"):
        world1.all_gather(1, vec)


def test_process_collective_per_tag_audit(world1):
    """A secondary tag may not run ahead of the primary rounds (Lemma 3)."""
    world1.all_gather(0, [1, 2])
    world1.all_gather(0, [1, 2], tag="secondary")
    with pytest.raises(ProtocolDesyncError, match="secondary"):
        world1.all_gather(0, [1, 2], tag="secondary")


class _Script:
    def __init__(self, script):
        self.script = script

    def on_gather(self, round_index, attempt, rank, tag):
        return self.script.get((round_index, attempt, rank))


def test_resilient_all_gather_retries_injected_drop(world1):
    """An injected drop is decided before the gather is issued: retried with
    backoff and recovered, the inner transport called once."""
    sleeps = []
    coll = ResilientCollective(world1, deadline_s=5.0, max_retries=2,
                               injector=_Script({(0, 0, 0): "drop"}), sleep_fn=sleeps.append)
    out = coll.all_gather(0, [5, 6])
    assert [o.tolist() for o in out] == [[5, 6]]
    assert coll.retries == 1 and coll.recovered == 1 and len(sleeps) == 1
    assert world1.stats.rounds == 1
    with pytest.raises(RankTimeoutError) as exc:
        ResilientCollective(world1, deadline_s=5.0, max_retries=1, sleep_fn=sleeps.append,
                            injector=_Script({(0, 0, 0): "drop", (0, 1, 0): 9.0})).all_gather(0, [1])
    assert exc.value.attempts == 2 and exc.value.failed_ranks == [0]


def _gather(tmp_path, scenario: str) -> list:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_rank_worker.gather_rank,
                         args=(r, 2, str(tmp_path / "pg"), str(tmp_path / f"{r}.pkl"), scenario))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    out = []
    for r in range(2):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_process_collective_two_gloo_ranks(tmp_path):
    seen = _gather(tmp_path, "roundtrip")
    want = [{"idx_budget": 10 + r, "n_groups": r - 1, "sizes": [r + 1], "tokens": [100 * (r + 1)]}
            for r in range(2)]
    for s in seen:
        assert s["payloads"] == want and s["rounds"] == 1
        assert s["resilient"] == [[0, 0, 0], [0, 1, 2]]


def test_process_collective_desync_raises_on_every_rank(tmp_path):
    seen = _gather(tmp_path, "desync")
    for s in seen:
        assert "uniform all_gather invariant violated" in s["desync"]


def test_rank_that_never_calls_times_out_without_retry(tmp_path):
    seen = _gather(tmp_path, "timeout")
    seconds, attempts, failed = seen[0]["timeout"]
    assert 0.5 <= seconds < 1.5  # one deadline, no retries after a real miss
    assert attempts == 1 and failed == [0]
