"""The train step's phases as the trainer records them: a ``train/forward``,
``train/backward`` and ``train/optimizer`` span a step inside its
``train/compute`` and ``train/step``, their host-clock counters, and, on the
card while tracing, their device time from CUDA events and the counts of
liveness-table builds and AdamW kernel launches; with the tracer off, no
span and no CUDA event.
Also the tracer's clock laid over ``torch.profiler``'s.

The file imports neither JAX nor the JAX package; the card test skips
itself where no CUDA device is present.
"""

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.models import LM
from repro_torch.kernels import adamw
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, tree_leaves
from repro_torch.train.trainer import StepPhases, Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

STEPS = 3
PHASES = StepPhases.NAMES
HOST = [f"train_{p}_seconds_total" for p in PHASES]
DEVICE = [f"train_{p}_device_seconds_total" for p in PHASES]


@pytest.fixture
def clean_obs():
    """A fresh default registry and tracer, the tracer off again after."""
    obs.default_registry().reset()
    obs.default_tracer().disable()
    obs.default_tracer().reset()
    try:
        yield obs.default_registry(), obs.default_tracer()
    finally:
        obs.default_tracer().disable()
        obs.default_tracer().reset()
        obs.default_registry().reset()


def _trainer(layout: str, device="cpu", steps: int = STEPS, **cfg):
    arch = dataclasses.replace(get_smoke_config("qwen3_0_6b"), **cfg)
    loader = OnlineDynamicLoader(
        get_dataset("uniform_narrow", scale=0.05), 2,
        OdbConfig(l_max=512, buffer_size=64, prefetch_factor=16),
        bucket_spec=BucketSpec(min_len=128, max_len=16384, max_count=1024),
        layout=layout, vocab_size=arch.vocab_size,
    )
    model = LM(arch, device=device)
    opt_cfg = OptimizerConfig(total_steps=100)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    trainer = Trainer(model, loader, opt_cfg, TrainerConfig(log_every=1, max_steps=steps))
    return trainer, {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _spans(tracer) -> dict:
    """name -> [(start_us, end_us, step)] of the trainer's X events."""
    out: dict = {}
    for e in tracer.events():
        if e.get("ph") == "X" and e["name"].startswith("train/"):
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("step")))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


class _CountingCounters:
    """The host counters' values after each step, read at each step's
    ``train/compute`` span."""

    def __init__(self, monkeypatch, trainer):
        self.after: list = []
        step = trainer._train_step

        def wrapped(state, batch):
            out = step(state, batch)
            flat = obs.default_registry().flat()
            self.after.append([flat.get(k, 0.0) for k in HOST])
            return out

        monkeypatch.setattr(trainer, "_train_step", wrapped)


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_phase_spans_nest_in_each_step(layout, clean_obs, monkeypatch):
    registry, tracer = clean_obs
    trainer, state = _trainer(layout)
    trainer._build_step()
    counted = _CountingCounters(monkeypatch, trainer)
    tracer.enable()
    _, n = trainer.train_epoch(state)
    assert n == STEPS
    spans = _spans(tracer)
    steps, computes = spans["train/step"], spans["train/compute"]
    assert [s[2] for s in steps] == [s[2] for s in computes] == list(range(1, STEPS + 1))
    for phase in PHASES:
        mine = spans[f"train/{phase}"]
        assert [s[2] for s in mine] == list(range(1, STEPS + 1)), phase
        for span, compute, step in zip(mine, computes, steps):
            assert _inside(span, compute) and _inside(compute, step)
    # Forward, backward and optimizer in that order, one after the other.
    for i in range(STEPS):
        ends = [spans[f"train/{p}"][i] for p in PHASES]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    # Every host counter advanced on every step; no device counter off the card.
    assert all(b > a for prev, cur in zip([[0.0] * 3] + counted.after, counted.after)
               for a, b in zip(prev, cur))
    flat = registry.flat()
    assert not set(DEVICE) & set(flat)
    assert "kernel_liveness_tables_built_total" not in flat  # the CPU takes the plain version
    assert "kernel_adamw_launches_total" not in flat  # and so does the optimizer


def test_untraced_step_records_no_span_and_no_event(clean_obs, monkeypatch):
    registry, tracer = clean_obs

    def refuse(what):
        def call(*args, **kwargs):
            raise AssertionError(f"{what} with the tracer off")
        return call

    monkeypatch.setattr(torch.cuda, "Event", refuse("a CUDA event"))
    monkeypatch.setattr(torch.cuda, "synchronize", refuse("a sync"))
    monkeypatch.setattr(torch.profiler, "record_function", refuse("a profiler range"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse("a profiler range"))
    trainer, state = _trainer("packed")
    trainer._build_step()
    counted = _CountingCounters(monkeypatch, trainer)
    _, n = trainer.train_epoch(state)
    assert n == STEPS
    assert tracer.events() == []
    assert len(counted.after) == STEPS
    assert all(b > a for prev, cur in zip([[0.0] * 3] + counted.after, counted.after)
               for a, b in zip(prev, cur))
    assert not set(DEVICE) & set(registry.flat())


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_phases_off_the_card_make_no_event(traced, clean_obs, monkeypatch):
    """A step function used alone (no trainer) on the CPU: its phases count
    on the host clock and, traced or not, make no CUDA event."""
    from repro_torch.train.trainer import assemble_model_batch, make_train_step

    registry, tracer = clean_obs
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: pytest.fail("a CUDA event off the card"))
    trainer, state = _trainer("packed")
    step = next(iter(trainer.loader.epoch(0)))
    batch = assemble_model_batch(step, trainer.loader.layout, "cpu")
    if traced:
        tracer.enable()
    phases = StepPhases("cpu")
    phases.step = 7
    make_train_step(trainer.model, trainer.opt_cfg, phases)(state, batch)
    phases.collect()
    flat = registry.flat()
    assert all(flat[k] > 0 for k in HOST) and not set(DEVICE) & set(flat)
    names = [(e["name"], e["args"]["step"]) for e in tracer.events()]
    assert names == ([(f"train/{p}", 7) for p in PHASES] if traced else [])


@pytest.mark.cuda
def test_phase_device_time_and_table_builds_on_card(clean_obs):
    """One traced step of a small packed GQA model, ``remat="full"``, on the
    pruned flash route: a table build per flash forward (two a layer), each
    phase's device time positive, their sum within the synced step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    registry, tracer = clean_obs
    trainer, state = _trainer("packed", device="cuda", steps=2, attn_impl="flash",
                              attn_grid="pruned", remat="full")
    trainer._build_step()
    step = trainer._train_step
    seen: dict = {}

    def second_traced(state_, batch):
        # Step 1 warms up; step 2 runs traced and is read alone.
        if seen:
            tracer.enable()
            seen["before"] = registry.flat()
        out = step(state_, batch)
        seen.setdefault("warm", True)
        return out

    trainer._train_step = second_traced
    trainer.train_epoch(state)
    after = registry.flat()
    delta = {k: after.get(k, 0.0) - seen["before"].get(k, 0.0) for k in after}
    assert delta["kernel_liveness_tables_built_total"] == 2 * trainer.model.cfg.n_layers
    leaves = tree_leaves(state["params"])
    launches = adamw.plan([p.numel() for p in leaves], [p.dtype for p in leaves])
    assert delta["kernel_adamw_launches_total"] == 2 * len(launches) + 1  # the optimizer's kernels, one step
    assert all(delta[k] > 0 for k in DEVICE)
    compute = _spans(tracer)["train/compute"][-1]
    assert sum(delta[k] for k in DEVICE) <= (compute[1] - compute[0]) / 1e6


def test_tracer_clock_lays_over_the_profiler():
    """A span and a ``record_function`` range entered together under
    ``torch.profiler`` land within 2 ms of each other once the span's ``ts``
    is put on the Unix clock through ``otherData.clock.origin_unix_ns``."""
    from torch.profiler import ProfilerActivity, profile

    tracer = obs.SpanTracer(enabled=False)
    tracer.reset()
    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("phase"), torch.profiler.record_function("phase_range"):
            torch.ones(4).sum()
    exported = tracer.export()
    origin = exported["otherData"]["clock"]["origin_unix_ns"]
    (span,) = [e for e in exported["traceEvents"] if e["name"] == "phase"]
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "phase_range"]
    assert abs(origin + 1000 * span["ts"] - rng.start_ns()) < 2e6


@pytest.mark.parametrize("pair_at", ["reset", "enable"])
def test_tracer_pairs_its_clock_at_reset_and_enable(pair_at, monkeypatch):
    """The origin on the Unix clock comes from the latest pair of readings,
    taken at ``reset()`` and at ``enable()``."""
    from repro_torch.obs import trace

    now = {"t": 100.0}
    tracer = obs.SpanTracer(clock=lambda: now["t"])
    now["t"] = 105.0
    tracer.reset()  # origin at 105 s
    now["t"] = 112.5
    monkeypatch.setattr(trace.time, "time_ns", lambda: 9_000_000_000)
    getattr(tracer, pair_at)()
    origin = 9_000_000_000 - (7_500_000_000 if pair_at == "enable" else 0)
    assert tracer.origin_unix_ns == origin
    assert tracer.export()["otherData"]["clock"] == {"origin_unix_ns": origin}
