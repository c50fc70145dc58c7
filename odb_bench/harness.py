"""One run of one cell: set-up, the measured window, the traced reading and
the check of what the window's path produced.

The program under test is the port's training path as its launcher wires
it (``repro_torch.launch.train.build``, with the launcher's defaults for
everything the cell does not name): ``Trainer.train_epoch`` over
``OnlineDynamicLoader.streaming_epoch`` (the streaming executor, DGAP rounds,
the batch layout, the prefetch thread), ``LM.loss_sums`` with per-layer
checkpointing and the in-place AdamW.  The benchmark hands it its inputs:
the weights (``weights.py``), the records and the tokens of every sample
(``generators/``, ``reference/data.sample_tokens``).

Set-up: import, the port's kernels (built once into the checkout's
``build/``), init (weights, model, optimizer state), traffic (records,
loader, trainer), and warm-up: the first ``WARMUP_STEPS`` steps of the
epoch through ``train_epoch`` itself.  Those steps are the ones the
reference follows.

The window is the next steps of the same ``train_epoch`` call: a fixed
count for the cell, ``seconds × window_steps_per_second`` (``cells/<cell>.json``),
which ``TrainerConfig.max_steps`` stops.  The epoch holds
``samples_per_rank`` samples a rank, many of the loader's grouping buffers,
so the batcher groups each buffer as it fills, as it does in a long epoch;
and every buffer holds the same multiset of lengths for every seed
(``generators/``), so the window is the same work whatever the seed.  Time
is the host clock from the window's start to a ``torch.cuda.synchronize()``
after its last step, taken as the trainer closes its data path and before
the loader's audit drain (the rest of the epoch's data-side schedule, which
a ``max_steps`` stop runs and which trains nothing; it is timed and printed
apart).  Work is the loader's accounting over the window.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import statistics
import time
import types

import numpy as np

from odb_bench import bounds, trace, weights
from odb_bench.reference import data as ref_data

WARMUP_STEPS = 3  # the steps the reference follows
OPTIMIZER = dict(lr=1e-5, warmup_ratio=0.03, total_steps=100, betas=(0.9, 0.95), eps=1e-8,
                 weight_decay=0.01, grad_clip=4.0, min_lr_fraction=0.1)  # the launcher's, at --steps 50
LAUNCHER = dict(buffer_size=256, prefetch_factor=64, num_workers=4, log_every=5,
                checkpoint_every=20, prefetch_depth=2)  # the train launcher's defaults
BUCKETS = dict(min_len=128, max_len=16384, max_count=1024)  # the launcher's bucket spec
ARRAYS = ("tokens", "positions", "segments", "loss_mask")


def dotted(tree: dict, key: str):
    for part in key.split("."):
        tree = tree[part]
    return tree


def port_config(config: dict):
    """The port's ArchConfig of the architecture, with every size the
    configuration file states put in."""
    from repro_torch.configs import get_config

    run = config["run"]
    return dataclasses.replace(get_config(run["arch"]),
                               **{f: dotted(config, k) for f, k in run["port"].items()})


def make_records(config: dict, traffic: dict, seed: int) -> list:
    """The epoch's records, laid out along the order in which the program's
    sampler hands each rank its identities (the loader's seed 0, epoch 0)."""
    from repro_torch.data.sampler import SamplerSpec, global_view_order, iteration_shuffle_epoch

    gen = importlib.import_module(f"odb_bench.generators.{traffic['generator']}")
    world = config["run"]["world"]
    n = world * traffic["samples_per_rank"]
    order = global_view_order(SamplerSpec(dataset_size=n, world_size=world), iteration_shuffle_epoch(0, 0))
    return gen.records(traffic, seed, [order[r::world] for r in range(world)])


def window_steps(window: dict, seconds: float) -> int:
    return max(1, round(seconds * window["window_steps_per_second"]))


class Feed:
    """Taps the trainer's step iterator: keeps each delivered step's host
    arrays and accounting, runs a hook at a step boundary and, when the
    trainer closes it, the close hooks before the data path's own close."""

    def __init__(self):
        self.steps: list = []  # (epoch, [per-rank arrays], samples_per_rank, tokens_per_rank)
        self.hooks: dict = {}  # delivered-step count -> fn, run before that step is pulled
        self.at_close: list = []
        self.close_s = 0.0
        self.hook_s = 0.0  # time the hooks took inside the trainer's data-path span
        self.pulled: list = []  # host clock at each step's pull

    def wrap(self, epoch: int, it):
        try:
            while True:
                hook = self.hooks.pop(len(self.steps), None)
                if hook is not None:
                    t = time.perf_counter()
                    hook()
                    self.hook_s += time.perf_counter() - t
                self.pulled.append(time.perf_counter())
                ls = next(it, None)
                if ls is None:
                    break
                md = ls.metadata
                self.steps.append((epoch, [{k: getattr(b, k) for k in ARRAYS} for b in ls.batches],
                                   md.samples_per_rank, md.tokens_per_rank))
                yield ls
        finally:
            while self.at_close:
                self.at_close.pop(0)()
            t = time.perf_counter()
            it.close()
            self.close_s = time.perf_counter() - t


def step_shape(ranks: list) -> tuple:
    """(global rows, row length, real segment lengths) of one step."""
    rows = sum(b["tokens"].shape[0] for b in ranks)
    cap = ranks[0]["tokens"].shape[1]
    lengths = [e - s for b in ranks for seg in b["segments"] for s, e in ref_data.segments_of(seg)]
    return rows, cap, lengths


def make_loader(name: str, config: dict, traffic: dict, records: list, seed: int, vocab: int):
    """The launcher's loader over the benchmark's records, its layout
    drawing every sample's tokens from the benchmark."""
    from repro_torch.core import BucketSpec, OdbConfig
    from repro_torch.core.layout import make_layout
    from repro_torch.data import OnlineDynamicLoader
    from repro_torch.data.datasets import DatasetSpec
    from repro_torch.data.pipeline import PipelinePolicy, RawRecord

    run, pipe = config["run"], traffic["pipeline"]
    raw = [RawRecord(identity=r["identity"], chars=r["chars"], turns=r["turns"],
                     image_pixels=r["image_pixels"]) for r in records]
    policy = PipelinePolicy(template=pipe["template"], cutoff_len=traffic["cutoff"],
                            chars_per_token=pipe["chars_per_token"],
                            template_tokens_per_turn=pipe["template_tokens_per_turn"],
                            visual_tokens_per_megapixel=pipe["visual_tokens_per_megapixel"],
                            tokenizer=pipe["tokenizer"])
    dataset = DatasetSpec(name=name, size=len(raw), policy=policy,
                          make_records=lambda size, _seed: raw[:size],
                          multimodal="image" in traffic)
    loader = OnlineDynamicLoader(
        dataset, world_size=run["world"],
        config=OdbConfig(l_max=run["l_max"], buffer_size=LAUNCHER["buffer_size"],
                         prefetch_factor=LAUNCHER["prefetch_factor"],
                         num_workers=LAUNCHER["num_workers"]),
        bucket_spec=BucketSpec(**BUCKETS), layout=run["layout"], vocab_size=vocab)
    loader.layout = make_layout(
        run["layout"], bucket_spec=loader.bucket_spec, packed_spec=loader.packed_spec,
        vocab_size=vocab,
        token_fn=lambda s: ref_data.sample_tokens(seed, s.identity, s.length, vocab))
    return loader


def leaf_specs(cfg) -> list:
    """(path, shape, dtype) of every leaf of the port's parameter tree."""
    from repro_torch.models import LM

    return [(path, tuple(leaf.shape), leaf.dtype)
            for path, leaf in weights.flatten(LM(cfg, device="meta").init())]


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, config: dict, traffic: dict, window: dict, seed: int, seconds: float,
             trace_on: bool, readers: dict, limits: dict, device="cuda", t_start: float | None = None,
             log=print):
    """One run; returns the result dict (without ``device`` and the
    modules check, which ``run.py`` adds)."""
    t_start = time.time() if t_start is None else t_start
    parts: dict = {}

    def done(part, t0):
        parts[part] = time.perf_counter() - t0

    t = time.perf_counter()
    import torch

    from repro_torch import obs
    from repro_torch.models import LM
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    done("import_s", t)
    run = config["run"]
    flops = importlib.import_module(f"odb_bench.flops.{run['family']}")
    on_card = torch.device(device).type == "cuda"

    t = time.perf_counter()
    cold = None
    if on_card:
        from repro_torch.kernels import build

        cold = [n for n in build.SOURCES if not build.library_path(n).exists()]
        build.build_all()
    done("kernels_s", t)

    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.zeros((), device=device)
    done("device_s", t)

    t = time.perf_counter()
    cfg = port_config(config)
    specs = leaf_specs(cfg)
    paths = [p for p, _, _ in specs]
    start = weights.make(specs, seed, device)
    # The program updates its leaves in place: the readings and the
    # reference take the start from this host copy, not from a redraw.
    start_host = weights.host_like(start, pin=on_card)
    for h, w in zip(start_host, start):
        h.copy_(w)
    model = LM(cfg, device=device)
    params = model.load_params(weights.unflatten(zip(paths, start)))
    del start
    opt_cfg = OptimizerConfig(**OPTIMIZER)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    synchronize(device)
    done("init_s", t)

    t = time.perf_counter()
    records = make_records(config, traffic, seed)
    vocab = cfg.vocab_size
    n_window = window_steps(window, seconds)
    if trace_on:
        n_window = max(n_window, run["trace_steps"] + 2)
    loader = make_loader(name, config, traffic, records, seed, vocab)
    trainer = Trainer(model, loader, opt_cfg, TrainerConfig(
        checkpoint_every=LAUNCHER["checkpoint_every"], log_every=LAUNCHER["log_every"],
        max_steps=WARMUP_STEPS + n_window, prefetch_depth=LAUNCHER["prefetch_depth"]))
    feed = Feed()
    epoch_steps = trainer._epoch_steps
    trainer._epoch_steps = lambda epoch: feed.wrap(epoch, epoch_steps(epoch))
    trainer._build_step()
    done("traffic_s", t)

    # Warm-up: the epoch's first steps, their readings kept.
    train_step = trainer._train_step
    losses, moment1, after = [], [], {}

    def capture(state_, batch):
        out = train_step(state_, batch)
        if len(losses) < WARMUP_STEPS:
            losses.append(out[1]["loss"].detach().float().clone())
            if len(losses) == 1:
                moment1.append(torch.stack([m.float().norm() for _, m in weights.flatten(out[0]["opt"]["m"])]))
            after["state"] = out[0]
        return out

    trainer._train_step = capture
    registry, tracer = obs.default_registry(), obs.default_tracer()
    program, at = {}, {}
    t_warmup = time.perf_counter()

    def start_window():
        # Before the first window step is pulled: the warm-up's readings,
        # then the window's clock, counters and peak.
        synchronize(device)
        parts["warmup_s"] = time.perf_counter() - t_warmup
        t0 = time.perf_counter()
        if on_card:
            at["program_bytes"] = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        b1 = OPTIMIZER["betas"][0]
        program["loss"] = [float(x) for x in losses]
        program["grad"] = (moment1[0] / (1 - b1)).tolist() if moment1 else []
        with torch.no_grad():  # one start leaf on the card at a time
            program["change"] = [float((p.float() - w.to(p.device).float()).norm())
                                 for (_, p), w in zip(weights.flatten(after["state"]["params"]), start_host)]
        after.clear()
        synchronize(device)
        at["readings_s"] = time.perf_counter() - t0
        if on_card:
            at["readings_peak"] = torch.cuda.max_memory_allocated(device)
        at["counters0"] = dict(registry.flat())
        at["accounting0"] = dataclasses.replace(loader.accounting)
        if trace_on:
            tracer.reset()
            tracer.enable()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        at["setup_s"] = time.time() - t_start - at["readings_s"]
        at["t0"] = time.perf_counter()
        at["pull"] = len(feed.pulled)

    def end_window():
        synchronize(device)
        at["t1"] = time.perf_counter()

    first = WARMUP_STEPS
    feed.hooks[first] = start_window
    prof, host_marks, profiled = None, [], []
    if trace_on:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
        n_prof = run["trace_steps"]

        def start_profile():
            prof.start()
            host_marks.append(trace.mark())

        def stop_profile():
            host_marks.append(trace.mark())
            prof.stop()
            profiled.extend(range(first + 1, len(feed.steps)))

        feed.hooks[first + 1] = start_profile
        feed.hooks[first + 1 + n_prof] = stop_profile
    feed.at_close.append(end_window)
    state, _ = trainer.train_epoch(state, epoch=0)
    synchronize(device)
    trainer._train_step = train_step
    if trace_on:
        tracer.disable()
    window_steps_run = feed.steps[first:]
    if "t0" not in at or len(window_steps_run) != n_window:
        raise RuntimeError(f"the epoch ran out: {len(feed.steps)} steps of {first + n_window}")
    window_s = at["t1"] - at["t0"]
    parts["drain_s"] = feed.close_s
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counters = {k: v - at["counters0"].get(k, 0.0) for k, v in registry.flat().items()}
    # The hooks ran inside the trainer's realize span.
    counters["train_realize_seconds_total"] = counters.get("train_realize_seconds_total", 0.0) - feed.hook_s
    accounting = {f: getattr(loader.accounting, f) - getattr(at["accounting0"], f)
                  for f in ("emitted_samples", "emitted_tokens", "device_tokens", "steps")}
    shapes = [step_shape(ranks) for _, ranks, _, _ in window_steps_run]
    model_flops = sum(flops.train_flops(config, lengths) for _, _, lengths in shapes)
    history = [h for h in trainer.history if h["step"] > WARMUP_STEPS]
    failed = sum(1 for h in history if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])))
    metrics = {
        "tokens_per_s": accounting["emitted_tokens"] / window_s,
        "samples_per_s": accounting["emitted_samples"] / window_s,
        "mfu": 100.0 * model_flops / (window_s * bounds.PEAK_FLOPS),
        "setup_s": at["setup_s"],
    }
    pulled = np.asarray(feed.pulled[at["pull"]:]) - at["t0"]
    step_s = np.diff(pulled)
    tenth = max(len(step_s) // 10, 1)
    info = dict(parts, readings_s=at["readings_s"], window_s=window_s, epoch_records=len(records),
                window_steps=n_window, warmup_steps=WARMUP_STEPS,
                steps_within_seconds=int(np.sum(pulled[1:] <= seconds)),
                step_s_first_tenth=float(np.mean(step_s[:tenth])), step_s_median=float(np.median(step_s)),
                step_s_last_tenth=float(np.mean(step_s[-tenth:])),
                cold_kernels=cold, model_flops=model_flops)
    breakdown = None
    if trace_on:
        spans = [(e["name"], tracer._origin + e["ts"] / 1e6, tracer._origin + (e["ts"] + e["dur"]) / 1e6)
                 for e in tracer.events() if e.get("ph") == "X" and e["name"].startswith("train/")]
        if len(host_marks) != 2:
            raise RuntimeError("the profiled steps did not run")
        profile_ = trace.Profile(prof.profiler.kineto_results.events(), host_marks, len(profiled))
        ctx = types.SimpleNamespace(
            config=config, flops=flops, profile=profile_, counters=counters, accounting=accounting,
            peak_bytes=peak, profiled=[step_shape(feed.steps[i][1]) for i in profiled])
        metrics = {}
        for metric, reader in readers.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[metric] = value
        info.update(busy_s=profile_.busy_s, traced_window_s=profile_.window_s,
                    profiled_steps=len(profiled))
        breakdown = {"device_ops": profile_.top_device_ops(), "idle_gaps": profile_.idle_gaps(spans)}
        del prof, profile_
    log(f"[odb_bench] {name} seed {seed}: " + " ".join(
        f"{k} {v}" for k, v in info.items()))

    # Free the program, then check what it produced.
    del trainer, loader, model, params, state, losses, moment1, capture, train_step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    checks = check(config, traffic, records, seed, vocab, feed, program, specs, start_host, device, limits, log)
    info["check_s"] = time.perf_counter() - t
    if on_card:
        gib = 2.0 ** -30
        log(f"[odb_bench] device peak: readings {at['readings_peak'] * gib} GiB, "
            f"{(at['readings_peak'] - at['program_bytes']) * gib} GiB over the program's "
            f"{at['program_bytes'] * gib} GiB; check {torch.cuda.max_memory_allocated(device) * gib} GiB")
    log(f"[odb_bench] check {info['check_s']:.1f} s: "
        + " ".join(f"{k} {v['value']} (limit {v['limit']})" for k, v in checks.items()))
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    return {"correct": correct, "attempted": n_window, "failed": failed,
            "metrics": metrics, "breakdown": breakdown, "peak_bytes": peak, "info": info,
            "checks": checks}


def check(config, traffic, records, seed, vocab, feed, program, specs, start, device, limits,
          log=print) -> dict:
    """The numbers compared, each with its limit: every delivered step's
    arrays against the records, and the program's first steps against the
    reference's."""
    checker = ref_data.DataCheck(records, traffic["pipeline"], traffic["cutoff"], seed, vocab)
    steps_samples, delivered = [], []
    for i, (_, ranks, samples_per_rank, tokens_per_rank) in enumerate(feed.steps):
        ids, samples = checker.step(i, ranks, samples_per_rank, tokens_per_rank)
        if i < WARMUP_STEPS:
            steps_samples.append(samples)
        delivered.extend(ids)
    checker.at_most_once(delivered)
    for line in checker.faults[:20]:
        log(f"[odb_bench] data fault: {line}")

    family = importlib.import_module(f"odb_bench.reference.{config['run']['family']}")
    ref = reference_readings(family, config, specs, start, device, steps_samples)
    counted = counted_leaves(ref["grad"])
    log(f"[odb_bench] losses: program {program['loss']} reference {ref['loss']}; "
        f"{len(counted)} of {len(ref['grad'])} leaves counted in the change")
    checks = {"data_faults": len(checker.faults)}
    checks.update(compare(program, ref, counted))
    uncompared = {k: v for k, v in checks.items() if k not in limits}
    if uncompared:
        log("[odb_bench] read, not compared: " + " ".join(f"{k} {v}" for k, v in uncompared.items()))
    return {k: {"value": v, "limit": limits[k]} for k, v in checks.items() if k in limits}


def reference_readings(family, config, specs, start, device, steps_samples, quant=None) -> dict:
    """The reference's three steps from the start weights ``start`` (host
    tensors in leaf order), on ``device``, in float32 with TF32 off."""
    import torch

    from odb_bench.reference import train as ref_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = [p for p, _, _ in specs]
    steps = [[torch.as_tensor(s, dtype=torch.int64, device=device) for _, s in samples]
             for samples in steps_samples]

    def loss_fn(leaves, samples, quant_):
        return family.loss_sums(weights.unflatten(zip(paths, leaves)), samples, config, quant_)

    return ref_train.train_readings(loss_fn, start, steps, OPTIMIZER, device, quant=quant)


def counted_leaves(ref_grad) -> list:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad)
    return [i for i, g in enumerate(ref_grad) if g >= 1e-3 * med]


def worst_leaf_gap(ours, ref, leaves) -> float:
    """The worst leaf's gap between the two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[i] for i in leaves)
    gaps = [abs(ours[i] - ref[i]) / max(ref[i], med, 1e-30) for i in leaves]
    return max(gaps) if len(ours) == len(ref) and all(map(math.isfinite, gaps)) else math.inf


def compare(program: dict, ref: dict, counted: list) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["loss"], ref["loss"]))
    if len(program["loss"]) != len(ref["loss"]) or not all(map(math.isfinite, program["loss"])):
        loss_gap = math.inf
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_leaf_gap(program["grad"], ref["grad"], range(len(ref["grad"]))),
        "change_gap": worst_leaf_gap(program["change"], ref["change"], counted),
    }
