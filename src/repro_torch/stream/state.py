"""Resumable loader/scheduler state (DESIGN.md §9.4).

A mid-epoch checkpoint of the streaming executor captures, layer by layer:

  * epoch-level accounting — iteration index, cumulative emit counts, the
    emitted-identity set (what Theorem 1's coverage audit is computed from)
    as a fixed-size identity *bitmap* (identities are dense in [0, N), so the
    serialized form is N/8 bytes regardless of how many logical iterations
    have emitted — the ledger no longer grows O(quota) per iteration), steps
    delivered so far;
  * the admission window — global cursor, staged-but-undelivered views,
    per-rank delivery counts (the shuffle order itself regenerates
    deterministically from (seed, epoch, iteration));
  * per-rank protocol residuals — the (R, Q, B) pools, the emitted count
    (component E is conservation-counted, never stored per sample), output
    queues, counters and local-finish flags;
  * engine round index, so Round records of a resumed run continue numbering.

Everything is JSON-serializable: samples flatten to ``[view_id, identity,
length]`` triples, groups to lists of triples, IDLE to ``null``.  Restoring
and continuing yields the *identical* step sequence the uninterrupted run
would have produced, so identity coverage (Theorem 1) is preserved across a
checkpoint/resume boundary — proven by tests/test_stream.py; the JSON schema is the JAX package's, so a
checkpoint taken by either package resumes in the other
(tests/test_torch_stream.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from repro_torch.core.grouping import Group, Sample
from repro_torch.core.protocol import IDLE, OdbConfig, RankCounters, RankRuntime

# v4: distributed window (DESIGN.md §16) — window state is keyed per *rank*
# (cursors/staged/delivered lists) instead of a single global cursor, the
# payload records ``num_hosts``, and the round audit carries the abort
# census; per-rank keying is what makes resume-at-a-different-host-count
# bit-exact, so earlier versions are rejected.
# v3: quarantine component X rode the checkpoint (runner quarantined ids +
# per-window quarantine records, DESIGN.md §15) so a resumed run keeps the
# extended (R, Q, B, E, X) accounting.
# v2: emitted ledgers shrank to count + identity bitmap (ROADMAP "checkpoint
# size"); v1 checkpoints carried per-sample emitted lists and are rejected.
STATE_VERSION = 4


# -- identity bitmap codec ----------------------------------------------------


def identities_to_bitmap(ids) -> str:
    """Hex-encoded bitmap with bit ``i`` set iff identity ``i`` was emitted.

    Identities are dense dataset indices, so the bitmap is ~N/8 bytes — the
    asymptotic fix for checkpoints on 10^7+-sample datasets, where the old
    sorted-id list cost ~8 bytes *per emitted view per logical iteration*.
    """
    if not ids:
        return ""
    buf = bytearray((max(ids) >> 3) + 1)
    for i in ids:
        buf[i >> 3] |= 1 << (i & 7)
    return bytes(buf).hex()


def bitmap_to_identities(bitmap: str) -> set[int]:
    out: set[int] = set()
    for byte_idx, byte in enumerate(bytes.fromhex(bitmap)):
        while byte:
            low = byte & -byte
            out.add((byte_idx << 3) + low.bit_length() - 1)
            byte ^= low
    return out


# -- sample / group / step codecs ---------------------------------------------


def sample_to_json(sample: Sample) -> list:
    return [sample.view_id, sample.identity, sample.length]


def sample_from_json(data: list) -> Sample:
    return Sample(view_id=data[0], identity=data[1], length=data[2])


def group_to_json(group: Group | None) -> list | None:
    if group is IDLE or group is None:
        return None
    return [sample_to_json(s) for s in group.samples]


def group_from_json(data: list | None) -> Group | None:
    if data is None:
        return IDLE
    return Group(samples=tuple(sample_from_json(s) for s in data))


def step_to_json(step: list[Group | None]) -> list:
    return [group_to_json(g) for g in step]


def step_from_json(data: list) -> list[Group | None]:
    return [group_from_json(g) for g in data]


# -- per-rank protocol residuals ----------------------------------------------


def rank_state_dict(rank: RankRuntime) -> dict:
    return {
        "pending": [sample_to_json(s) for s in rank.pending],
        "worker_queue": [sample_to_json(s) for s in rank.worker_queue],
        "buffer": [sample_to_json(s) for s in rank.buffer],
        "emitted_count": rank.emitted_count,
        "out_queue": [group_to_json(g) for g in rank.out_queue],
        "counters": dataclasses.asdict(rank.counters),
        "local_finished": rank.local_finished,
        "admitted": rank.admitted,
        "drain_rate": rank.drain_rate,
    }


def load_rank_state(rank: RankRuntime, state: dict) -> None:
    rank.pending.clear()
    rank.pending.extend(sample_from_json(s) for s in state["pending"])
    rank.worker_queue.clear()
    rank.worker_queue.extend(sample_from_json(s) for s in state["worker_queue"])
    rank.buffer = [sample_from_json(s) for s in state["buffer"]]
    rank.emitted_count = state["emitted_count"]
    rank.out_queue.clear()
    rank.out_queue.extend(group_from_json(g) for g in state["out_queue"])
    rank.counters = RankCounters(**state["counters"])
    rank.local_finished = state["local_finished"]
    rank.admitted = state["admitted"]
    rank.drain_rate = state["drain_rate"]


# -- the checkpoint -----------------------------------------------------------


@dataclasses.dataclass
class StreamCheckpoint:
    """One serializable snapshot of a :class:`StreamExecutor` between steps."""

    payload: dict[str, Any]

    @property
    def step_index(self) -> int:
        return self.payload["runner"]["steps_delivered"]

    @property
    def epoch(self) -> int:
        return self.payload["epoch"]

    def config(self) -> OdbConfig:
        return OdbConfig(**self.payload["config"])

    def to_json(self) -> str:
        return json.dumps(self.payload)

    @classmethod
    def from_json(cls, text: str) -> "StreamCheckpoint":
        payload = json.loads(text)
        version = payload.get("version")
        if version != STATE_VERSION:
            raise ValueError(
                f"unsupported stream checkpoint version {version!r} "
                f"(expected {STATE_VERSION})"
            )
        return cls(payload)

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json())
        os.replace(tmp, path)  # atomic publish, same as train/checkpoint.py

    @classmethod
    def load(cls, path: str) -> "StreamCheckpoint":
        with open(path) as fh:
            return cls.from_json(fh.read())
