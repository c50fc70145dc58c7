"""Serving requests and the live-queue admission window.

A serving request is the inference-time analogue of a sampler view: its true
cost (prompt tokens + decode budget = the KV-cache footprint it will pin) is
*realized* only when the request reaches the tokenizer — the same
observability constraint ODB trains under.  :class:`RequestWindow` therefore
reuses the :class:`~repro_torch.stream.window.BoundedWindow` mechanics: a
single cursor over an (append-only) arrival order, realization on
admission, and a ``lookahead`` bound on
realized-but-unscheduled requests (backpressure by refusal, never by
blocking — an overloaded engine stops *realizing*, it does not drop).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.grouping import Sample
from repro_torch.stream.window import BoundedWindow


def synth_request_trace(
    n: int,
    *,
    vocab: int,
    prompt_min: int,
    prompt_max: int,
    new_min: int,
    new_max: int,
    seed: int,
) -> list[tuple[np.ndarray, int]]:
    """Heterogeneous request profile: uniform prompts, long-tail decode budgets.

    The decode-budget spread is the quantity static batching is blind to — a
    static batch decodes for its *max* budget while paying device steps for
    every slot, so its useful-slot occupancy is roughly mean/max of the
    profile.  The same generator as the JAX package's, so both engines can
    be fed one trace.
    """
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(prompt_min, prompt_max + 1))
        new = int(
            np.clip(rng.geometric(2.0 / (new_min + new_max)), new_min, new_max)
        )
        out.append((rng.integers(1, vocab, size=plen).astype(np.int32), new))
    return out


QUEUED = "queued"  # submitted, not yet realized by the window
WAITING = "waiting"  # realized cost, waiting for slot + budget
RUNNING = "running"  # occupies a KV slot
FINISHED = "finished"
EVICTED = "evicted"  # cancelled mid-flight; slot reclaimed
SHED = "shed"  # TTL expired while queued/waiting; never held a slot


@dataclasses.dataclass
class Request:
    """One decode request moving through the continuous-batching engine."""

    rid: int
    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int
    eos_id: int | None = None
    # Queueing deadline: shed (never schedule) once now - submitted_s exceeds
    # it.  None defers to the engine-wide ServeConfig.default_ttl_s.
    ttl_s: float | None = None
    state: str = QUEUED
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    # wall-clock trajectory (drives the launcher's latency percentiles)
    submitted_s: float = 0.0
    first_token_s: float | None = None
    finished_s: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def projected_tokens(self) -> int:
        """KV-cache footprint bound: prompt plus the full decode budget.

        This is the ``l`` that admission feeds the Eq.-1 token-budget rule —
        conservative by construction, so the in-flight sum can never outgrow
        ``l_max`` mid-decode (a request that stops early only under-uses its
        reservation).
        """
        return self.prompt_len + self.max_new_tokens

    @property
    def latency_s(self) -> float | None:
        if self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s


class RequestWindow(BoundedWindow):
    """Bounded admission over a live request queue (single scheduler rank).

    The order grows as requests are submitted and stays *open* until
    :meth:`close` — ``exhausted`` therefore means "closed and drained", so a
    serving loop can run until the queue is declared final (batch jobs,
    benchmarks) or keep ticking forever (online serving).  Realization stamps
    the request's projected token cost into a :class:`Sample` whose payload
    is the request itself, which is exactly what
    :func:`repro_torch.core.grouping.greedy_group` consumes for admission
    cohorts.
    """

    def __init__(self, *, lookahead: int) -> None:
        super().__init__(lookahead)
        self._arrivals: list[Request] = []
        self._closed = False

    def submit(self, request: Request) -> None:
        if self._closed:
            raise RuntimeError("request queue is closed")
        self._arrivals.append(request)

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    # -- BoundedWindow order interface -----------------------------------------
    def order_size(self) -> int:
        return len(self._arrivals)

    def order_open(self) -> bool:
        return not self._closed

    def realize(self, position: int) -> Sample:
        request = self._arrivals[position]
        request.state = WAITING
        return Sample(
            view_id=position,
            identity=request.rid,
            length=request.projected_tokens,
            payload=request,
        )
