"""Continuous-batching serving engine on the ODB admission core.

The ROADMAP observation made real: the incremental admission loop the
trainer runs (bounded-lookahead realization + greedy ``l_max`` token-budget
grouping) *is* a continuous-batching scheduler.  One engine tick is

  1. **admit** — pull realized requests from the :class:`RequestWindow`
     (lookahead-bounded, exactly the training backpressure), form an
     admission cohort with :func:`repro_torch.core.grouping.greedy_group` under the
     budget headroom ``l_max − Σ projected(in-flight)``, and allocate one KV
     slot per admitted request;
  2. **prefill** — pack the cohort's prompts into one segment-masked stream
     (``PackedLayout`` planning) and run the slot-scatter prefill (on the
     card, through the pruned segment flash kernel), which lands every
     request's K/V in its slot and returns each cohort member's first token;
  3. **decode** — one fixed-shape ``(num_slots, 1)`` step over *all* resident
     requests at their individual cache frontiers; completions free slots
     that the next tick's admission refills.

Fixed shapes: the decode step runs at exactly one shape per engine, the
prefill at one shape per occupied ``(rows, capacity)`` bucket — admission,
eviction and slot reuse never change a device shape (the step censuses of
``launch/steps.py`` count them).

``continuous=False`` degrades the same machinery to classic static batching
— admit only into an *empty* engine, then drain the whole batch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.buckets import PackedBucketSpec
from repro_torch.core.grouping import Group, Sample, greedy_group
from repro_torch.core.layout import PackedLayout
from repro_torch.device import resolve_device
from repro_torch.launch.shapes import ServeCell
from repro_torch.launch.steps import build_serve_decode_step, build_serve_prefill_step
from repro_torch.models.model import LM
from repro_torch.serve.requests import (
    EVICTED,
    FINISHED,
    RUNNING,
    SHED,
    Request,
    RequestWindow,
)
from repro_torch.serve.slots import SlotManager


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs; shape-relevant fields mirror a ``ServeCell``."""

    num_slots: int = 8  # decode rows == KV slots
    max_len: int = 256  # per-slot KV capacity
    l_max: int = 1024  # shared admission token budget (Eq. 1 reused)
    lookahead: int = 32  # realized-but-unscheduled request bound
    continuous: bool = True  # False = static batching baseline
    prefill_min_tokens: int = 64  # packed prefill stream bucket floor
    # Engine-wide queueing TTL: a request still waiting for
    # a slot this many seconds after submission is shed at admission time
    # instead of scheduled into a batch whose caller already gave up.  None
    # disables shedding; per-request Request.ttl_s overrides.
    default_ttl_s: float | None = None

    def cell(self, name: str = "serve") -> ServeCell:
        return ServeCell(name, self.num_slots, self.max_len, self.l_max)

    def prefill_spec(self) -> PackedBucketSpec:
        # max_rows = num_slots: worst case every cohort member needs its own
        # row, so a plan always exists for any cohort the admission rule can
        # form (each prompt fits one row of the widest capacity).
        return PackedBucketSpec(
            min_tokens=self.prefill_min_tokens,
            max_tokens=self.max_len,
            max_rows=self.num_slots,
        )


@dataclasses.dataclass
class ServeStats:
    ticks: int = 0
    decode_steps: int = 0
    prefill_calls: int = 0
    admitted: int = 0
    finished: int = 0
    evicted: int = 0
    shed: int = 0  # TTL-expired while waiting; never occupied a slot
    generated_tokens: int = 0
    # max Σ projected over any tick; ≤ l_max under continuous admission (the
    # static baseline packs slots-only, deliberately ignoring the budget)
    peak_projected_tokens: int = 0
    peak_active_slots: int = 0
    slot_decode_occupancy: float = 0.0  # Σ active / (decode_steps · num_slots)
    _occupied_rows: int = 0


class ContinuousBatchingEngine:
    """Slot-cache continuous batching over a live request queue, on one
    device: the CUDA card unless ``device="cpu"`` is asked for (it must be
    the model's)."""

    def __init__(
        self,
        model: LM,
        params,
        config: ServeConfig,
        *,
        device=None,
        time_fn=time.perf_counter,
        step_cache: dict | None = None,
    ) -> None:
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} != model device {model.device}")
        cfg = model.cfg
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: nothing to serve")
        if cfg.attn_kind == "mla" or any(
            cfg.layer_kind(l) != "attn" for l in range(cfg.n_layers)
        ):
            raise NotImplementedError(
                "the slot-scatter prefill path serves GQA-attention stacks"
            )
        self.model = model
        self.params = params
        self.config = config
        self.time_fn = time_fn
        self.cell = config.cell()
        self.window = RequestWindow(lookahead=config.lookahead)
        self.slots = SlotManager(config.num_slots, config.max_len)
        self.waiting: list[Sample] = []
        self.requests: dict[int, Request] = {}
        self.stats = ServeStats()
        self._next_rid = 0
        self._layout = PackedLayout(spec=config.prefill_spec())
        self.caches = model.init_caches(config.num_slots, config.max_len)
        # ``step_cache`` lets engines over the same (model, cell) share step
        # functions; the censuses travel with the cached entry, so the
        # fixed-shape contract holds *across* sharing engines.
        self._step_cache = step_cache if step_cache is not None else {}
        key = ("decode", config.num_slots, config.max_len)
        if key not in self._step_cache:
            self._step_cache[key] = build_serve_decode_step(model, self.cell)
        self._decode_fn, self._decode_traces = self._step_cache[key]
        # Telemetry: instruments cached once per engine.
        self._m_ticks = obs.counter("serve_ticks_total", help="engine scheduler ticks")
        self._m_admitted = obs.counter(
            "serve_admitted_total", help="requests admitted into KV slots"
        )
        self._m_finished = obs.counter(
            "serve_finished_total", help="requests completed"
        )
        self._m_evicted = obs.counter("serve_evicted_total", help="requests evicted")
        self._m_shed = obs.counter(
            "odb_serve_shed_total",
            help="requests shed at admission because their queueing TTL expired",
        )
        self._m_occupancy = obs.gauge(
            "serve_slot_occupancy", help="active KV slots / num_slots after last tick"
        )
        self._m_queue_depth = obs.gauge(
            "serve_queue_depth",
            help="waiting pool + undelivered submissions after last tick",
        )
        self._m_ttft = obs.histogram(
            "serve_ttft_seconds",
            help="submit-to-first-token latency",
            unit="seconds",
        )

    # -- observability ---------------------------------------------------------
    @property
    def decode_traces(self) -> int:
        """Distinct shapes the decode step ran at (fixed-shape contract: 1)."""
        return self._decode_traces.count

    @property
    def prefill_traces(self) -> dict[tuple[int, int], int]:
        """Per-(rows, cap) bucket shape counts (1 each).

        Scoped to THIS engine's cell: a shared ``step_cache`` may hold
        buckets for other (num_slots, max_len) cells whose identical
        (rows, cap) display keys would otherwise shadow each other.
        """
        own = ("prefill", self.config.num_slots, self.config.max_len)
        return {
            key[-1]: census.count
            for key, (_, census) in self._step_cache.items()
            if key[:3] == own
        }

    @property
    def done(self) -> bool:
        return (
            self.window.exhausted()
            and not self.waiting
            and self.slots.active_count == 0
        )

    # -- request lifecycle -----------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        eos_id: int | None = None,
        ttl_s: float | None = None,
    ) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] == 0:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got {max_new_tokens}")
        cost = int(prompt.shape[0]) + max_new_tokens
        limit = min(self.config.l_max, self.config.max_len)
        if cost > limit:
            raise ValueError(
                f"request projects {cost} tokens > "
                f"min(l_max, max_len) = {limit}: it could never be admitted"
            )
        rid = self._next_rid
        self._next_rid += 1
        request = Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            ttl_s=ttl_s,
            submitted_s=self.time_fn(),
        )
        self.requests[rid] = request
        self.window.submit(request)
        return rid

    def evict(self, rid: int) -> Request:
        """Cancel a resident request; its slot frees for the next admission."""
        request = self.requests[rid]
        if request.state != RUNNING or request.slot is None:
            raise ValueError(f"request {rid} is not running ({request.state})")
        self.slots.release(request.slot)
        request.state = EVICTED
        request.finished_s = self.time_fn()
        self.stats.evicted += 1
        self._m_evicted.inc()
        return request

    def _finish(self, request: Request) -> None:
        self.slots.release(request.slot)
        request.state = FINISHED
        request.finished_s = self.time_fn()
        self.stats.finished += 1
        self._m_finished.inc()

    # -- admission (tick phase 1) ----------------------------------------------
    def _shed_expired(self) -> None:
        """Drop waiting-pool requests whose queueing TTL has lapsed.

        Load shedding happens at the admission boundary only: a request that
        reached RUNNING keeps its slot (mid-decode cancellation is
        :meth:`evict`, a caller decision).  Under saturation this is what
        keeps the queue from growing without bound — every tick either admits
        work or retires expired work, so the engine always terminates on a
        closed queue even when the offered load exceeds capacity.
        """
        if not self.waiting:
            return
        now = self.time_fn()
        kept: list[Sample] = []
        for sample in self.waiting:
            request = sample.payload
            ttl = (
                request.ttl_s
                if request.ttl_s is not None
                else self.config.default_ttl_s
            )
            if ttl is not None and now - request.submitted_s > ttl:
                request.state = SHED
                request.finished_s = now
                self.stats.shed += 1
                self._m_shed.inc()
            else:
                kept.append(sample)
        self.waiting = kept

    def _admit(self) -> list[Sample]:
        # Hold a grouping pool of up to 2·num_slots realized requests; the
        # window's lookahead bounds realization no matter how greedy this is.
        want = 2 * self.config.num_slots - len(self.waiting)
        if want > 0:
            self.waiting.extend(self.window.take(want))
        # Shed before any early return: under full-slot saturation (free==0,
        # the regime shedding exists for) expired waiters must still retire this
        # tick, or a saturated engine never drains its queue and the
        # closed-queue termination claim fails.
        self._shed_expired()
        if not self.config.continuous and self.slots.active_count > 0:
            return []  # static batching: drain fully before refilling
        free = self.slots.free_count
        if free == 0:
            return []
        if not self.waiting:
            return []
        if not self.config.continuous:
            cohort = self.waiting[:free]  # arrival order, slots-only rule
            self.waiting = self.waiting[free:]
            return cohort
        budget = self.config.l_max - self.slots.projected_in_flight()
        cohort: list[Sample] = []
        # Greedy token-budget grouping (paper §2.2) orders the pool longest-first
        # under the same B(l) threshold-carry rule training uses; admission
        # walks that order and stops at the first request the remaining
        # budget cannot hold (head-of-line blocking, so budget-starved long
        # requests are never overtaken forever).
        for group in greedy_group(self.waiting, self.config.l_max):
            for sample in group.samples:
                if len(cohort) >= free or sample.length > budget:
                    taken = {s.view_id for s in cohort}
                    self.waiting = [
                        s for s in self.waiting if s.view_id not in taken
                    ]
                    return cohort
                cohort.append(sample)
                budget -= sample.length
        taken = {s.view_id for s in cohort}
        self.waiting = [s for s in self.waiting if s.view_id not in taken]
        return cohort

    # -- prefill (tick phase 2) ------------------------------------------------
    def _prefill_fn(self, shape: tuple[int, int]):
        key = ("prefill", self.config.num_slots, self.config.max_len, shape)
        if key not in self._step_cache:
            self._step_cache[key] = build_serve_prefill_step(
                self.model, self.cell, shape[0], shape[1]
            )
        return self._step_cache[key][0]

    def _prefill(self, cohort: list[Sample]) -> None:
        num_slots = self.config.num_slots
        for sample in cohort:
            self.slots.alloc(sample.payload)
        # Reservation high-water mark: sampled here, before completions can
        # release budget later in the same tick (a 1-token cohort would
        # otherwise read back as zero in-flight).
        self.stats.peak_projected_tokens = max(
            self.stats.peak_projected_tokens, self.slots.projected_in_flight()
        )
        # Plan the packed stream over *prompt* lengths (what prefill ships),
        # not the projected costs admission budgeted (prompt + decode room).
        prompts = tuple(
            dataclasses.replace(s, length=s.payload.prompt_len) for s in cohort
        )
        cap, rows = self._layout.plan_rows(Group(samples=prompts))
        n_rows = self._layout.spec.bucket_rows(len(rows))
        tokens = np.zeros((n_rows, cap), np.int32)
        positions = np.zeros((n_rows, cap), np.int32)
        segments = np.zeros((n_rows, cap), np.int32)
        # Padding stream positions scatter to row ``num_slots`` — one past the
        # cache — and are dropped on the device.
        dest = np.full((n_rows, cap), num_slots, np.int32)
        gather_rows = np.zeros((num_slots,), np.int32)
        gather_cols = np.zeros((num_slots,), np.int32)
        live = np.zeros((num_slots,), bool)
        for r, row in enumerate(rows):
            cursor = 0
            for seg_id, sample in enumerate(row, start=1):
                request = sample.payload
                end = cursor + sample.length
                tokens[r, cursor:end] = request.prompt
                positions[r, cursor:end] = np.arange(sample.length, dtype=np.int32)
                segments[r, cursor:end] = seg_id
                dest[r, cursor:end] = request.slot
                gather_rows[request.slot] = r
                gather_cols[request.slot] = end - 1
                live[request.slot] = True
                cursor = end
        fn = self._prefill_fn((n_rows, cap))
        dev = self.device
        picked, self.caches = fn(
            self.params, self.caches,
            *(torch.from_numpy(a).to(dev) for a in
              (tokens, positions, segments, dest, gather_rows, gather_cols)),
        )
        first = picked.argmax(dim=-1).to(torch.int32).cpu().numpy()
        now = self.time_fn()
        for sample in cohort:
            request = sample.payload
            request.state = RUNNING
            request.first_token_s = now
            self._m_ttft.observe(now - request.submitted_s)
            token = int(first[request.slot])
            request.generated = [token]
            self.slots.lengths[request.slot] = request.prompt_len
            self.slots.last_token[request.slot] = token
            self.stats.generated_tokens += 1
            if self._is_complete(request, token):
                self._finish(request)
        self.stats.prefill_calls += 1
        self.stats.admitted += len(cohort)

    def _is_complete(self, request: Request, token: int) -> bool:
        if len(request.generated) >= request.max_new_tokens:
            return True
        return request.eos_id is not None and token == request.eos_id

    # -- decode (tick phase 3) -------------------------------------------------
    def _decode(self) -> None:
        active = self.slots.active()
        if not active:
            return
        nxt, self.caches = self._decode_fn(
            self.params, self.caches,
            torch.from_numpy(self.slots.last_token[:, None]).to(self.device),
            torch.from_numpy(self.slots.lengths).to(self.device),
        )
        nxt = nxt.cpu().numpy()
        for slot, request in active:
            # The fed token's K/V is cached now; the frontier advances.
            self.slots.lengths[slot] += 1
            token = int(nxt[slot, 0])
            request.generated.append(token)
            self.slots.last_token[slot] = token
            self.stats.generated_tokens += 1
            if self._is_complete(request, token):
                self._finish(request)
        self.stats.decode_steps += 1
        self.stats._occupied_rows += len(active)
        total = self.stats.decode_steps * self.config.num_slots
        self.stats.slot_decode_occupancy = self.stats._occupied_rows / total

    # -- scheduler -------------------------------------------------------------
    def tick(self) -> None:
        with obs.span("serve/tick", cat="serve", tick=self.stats.ticks):
            with obs.span("serve/admit", cat="serve"):
                cohort = self._admit()
            if cohort:
                with obs.span("serve/prefill", cat="serve", cohort=len(cohort)):
                    self._prefill(cohort)
                self._m_admitted.inc(len(cohort))
            with obs.span("serve/decode", cat="serve"):
                self._decode()
        self.stats.ticks += 1
        self._m_ticks.inc()
        self._m_occupancy.set(self.slots.active_count / self.config.num_slots)
        self._m_queue_depth.set(len(self.waiting) + self.window.remaining())
        self.stats.peak_projected_tokens = max(
            self.stats.peak_projected_tokens, self.slots.projected_in_flight()
        )
        self.stats.peak_active_slots = max(
            self.stats.peak_active_slots, self.slots.active_count
        )

    def run(self, *, close: bool = True) -> dict[int, np.ndarray]:
        """Tick until the (closed) queue drains; returns rid → generated ids."""
        if close and not self.window.closed:
            self.window.close()
        if not self.window.closed:
            raise RuntimeError("run() needs a closed queue; use tick() online")
        while not self.done:
            self.tick()
        return {
            rid: np.asarray(r.generated, np.int32)
            for rid, r in self.requests.items()
            if r.state == FINISHED
        }
