#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in the checkout (one ``nvcc`` per
source, in parallel), then runs:

1. device    — the card's name and power limit (``nvidia-smi``), device count;
2. parity    — the forward kernels, dense (K1) and pruned (K4), at the serving
               shapes, (rows, capacity) in {(1,64), (2,128), (6,128), (8,256)}
               with 16 q heads over 8 kv heads, d_head 128, held against the
               plain PyTorch version on valid rows (bf16: atol = rtol = 2e-2;
               fp32: 2e-5; lse in fp32 at 2e-5), K4 against K1 with
               ``torch.equal``, and the liveness tables built on the card
               against the same tables built on the CPU;
3. backward  — the four backward kernels, dQ and dK/dV of the dense (K2, K3)
               and pruned (K5, K6) grids, at the serving shapes, at the first
               training step's packed shape and at S = 200 (block 40), in bf16
               and fp32: each against the plain backward on valid rows at the
               tolerances above, K5 == K2 and K6 == K3 with ``torch.equal``,
               and exactly zero gradients on all-padding rows;
4. serving   — ``ContinuousBatchingEngine`` on full-width Qwen3-0.6B in bf16
               (random weights from seed 0) with the launcher's defaults; every
               request must finish, K4 must launch 28 times per prefill call and
               K1 never; the same trace on the dense kernel must give the
               identical ids; the first prefill's picked logits on the kernel
               route are held against the plain route's; ``torch.profiler``
               reads the card's busy share over the first eight ticks;
5. training  — ``Trainer`` on full-width Qwen3-0.6B in bf16 (random weights
               from seed 0) through the train launcher's data path
               (``--layout packed --world 2 --l-max 4096``, TRAIN_STEPS steps):
               finite loss and grad_norm every step, per step K4 launched
               2 x 28 times (remat recomputes the forward), K5 and K6 28 times,
               K1-K3 never; the same steps on ``attn_grid="dense"`` launch K1
               2 x 28, K2 and K3 28 times per step, K4-K6 never, and give the
               same per-step losses within LOSS_RTOL; tokens/s, step time and
               peak memory, and ``torch.profiler``'s busy share over two steps;
6. times     — K1, K4 at the serving shapes and K2, K3, K5, K6 at the first
               training step's shape: the kernel, the plain version,
               ``scaled_dot_product_attention`` and its backward with the same
               boolean mask (a yardstick only: the port never calls it), and
               the bound;
7. kernels   — one JSON line with every ported kernel.

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.  It
needs a CUDA device and the repository around it.  It pins PYTHONHASHSEED
to 0 (re-executing itself once) because the data path's synthetic dataset
hashes tuples, so the training shapes are the same in every run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((1, 64), (2, 128), (6, 128), (8, 256))  # (rows, capacity) of the prefill stream
HEADS, KV_HEADS, D_HEAD = 16, 8, 128
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PEAK_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# The training run: the train launcher's flags.  Two ranks at l_max 4096
# give steps of at most 2 x 6144 token slots: the fp32 logits (~7.5 GB a
# copy, ~3 copies at the backward's peak) beside ~7 GB of bf16 weights,
# gradients and fp32 moments.
TRAIN_STEPS = 4
TRAIN_ARGS = ["--arch", "qwen3_0_6b", "--layout", "packed", "--world", "2", "--l-max", "4096",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# Per-step losses of the dense and pruned routes: the kernels of the two
# routes are bit-exact pairs, so only the order of atomic adds outside them
# (the embedding gradient) differs; bf16 weights.
LOSS_RTOL = 1e-2
FWD = "src/repro_torch/kernels/csrc/flash_fwd.cu"
BWD = "src/repro_torch/kernels/csrc/flash_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention.py"
KERNELS = {  # name -> (source, TPU kernel it replaces, grid, C entry point)
    "segment_flash_attention": (FWD, f"{REPLACES}:211", "dense", None),
    "segment_flash_attention_pruned": (FWD, f"{REPLACES}:622", "pruned", None),
    "segment_flash_attention_bwd_dq": (BWD, f"{REPLACES}:485", "dense", "flash_bwd_dq_dense"),
    "segment_flash_attention_bwd_dkv": (BWD, f"{REPLACES}:522", "dense", "flash_bwd_dkv_dense"),
    "segment_flash_attention_bwd_pruned_dq": (BWD, f"{REPLACES}:881", "pruned", "flash_bwd_dq_pruned"),
    "segment_flash_attention_bwd_pruned_dkv": (BWD, f"{REPLACES}:933", "pruned",
                                               "flash_bwd_dkv_pruned"),
}
BWD_PAIRS = (("segment_flash_attention_bwd_dq", "segment_flash_attention_bwd_pruned_dq"),
             ("segment_flash_attention_bwd_dkv", "segment_flash_attention_bwd_pruned_dkv"))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def packed_segments(rng, rows: int, cap: int):
    """Seeded packing: prompts of random length back to back, a padding tail."""
    import numpy as np

    seg = np.zeros((rows, cap), np.int32)
    for r in range(rows):
        end = cap - int(rng.integers(1, cap // 4))
        cursor, seg_id = 0, 1
        while cursor < end:
            n = int(rng.integers(8, 97))
            seg[r, cursor:min(end, cursor + n)] = seg_id
            cursor, seg_id = cursor + n, seg_id + 1
    return seg


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    return name, count


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for log in build.BUILD_LOGS.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")


def make_case(rng, seg, dtype):
    """q, k, v from the seed for the (rows, cap) numpy segment ids ``seg``."""
    import numpy as np
    import torch

    rows, cap = seg.shape
    qkv = [
        torch.from_numpy(rng.standard_normal((rows, cap, n, D_HEAD), dtype=np.float32)).to("cuda", dtype)
        for n in (HEADS, KV_HEADS, KV_HEADS)
    ]
    return (*qkv, torch.from_numpy(seg).cuda())


def phase_parity(rng):
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_ref

    max_err = {"segment_flash_attention": 0.0, "segment_flash_attention_pruned": 0.0}
    for rows, cap in SHAPES:
        blk = fa.select_block(cap, 128)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, seg = make_case(rng, packed_segments(rng, rows, cap), dtype)
            kw = dict(block_q=blk, block_kv=blk, return_lse=True)
            o1, l1 = fa.segment_flash_attention(q, k, v, seg, **kw)
            o4, l4 = fa.segment_flash_attention_pruned(q, k, v, seg, **kw)
            ro, rl = segment_flash_attention_ref(q, k, v, seg, return_lse=True)
            torch.cuda.synchronize()
            valid = seg > 0
            tol = TOL[dname]
            for name, o, l in (("segment_flash_attention", o1, l1),
                               ("segment_flash_attention_pruned", o4, l4)):
                ok_out = torch.allclose(o[valid].float(), ro[valid].float(), atol=tol, rtol=tol)
                ok_lse = torch.allclose(l[valid], rl[valid], atol=TOL["float32"], rtol=TOL["float32"])
                err = (o[valid].float() - ro[valid].float()).abs().max().item()
                lerr = (l[valid] - rl[valid]).abs().max().item()
                check(ok_out and ok_lse, f"{name} vs plain at {(rows, cap)} {dname}: "
                                         f"out err {err}, lse err {lerr}")
                if dname == "bfloat16":
                    max_err[name] = max(max_err[name], err)
                print(f"[parity] {name} rows={rows} cap={cap} {dname}: "
                      f"max_abs_err out {err:.3g} lse {lerr:.3g} (tol {tol})")
            check(torch.equal(o1, o4) and torch.equal(l1, l4),
                  f"K4 not bit-exact vs K1 at {(rows, cap)} {dname}")
            print(f"[parity] K4 == K1 bit-exact rows={rows} cap={cap} {dname}")
        on_card = build_liveness_tables(seg, block_q=blk, block_kv=blk)
        on_cpu = build_liveness_tables(seg.cpu(), block_q=blk, block_kv=blk)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
              f"liveness tables differ between card and CPU at {(rows, cap)}")
        print(f"[parity] liveness tables card == cpu rows={rows} cap={cap} "
              f"live tiles {int(on_card.kv_count.sum())}/{rows * (cap // blk) ** 2}")
    return max_err


def training_segments():
    """The segment ids of the training run's first step, from the train
    launcher's data path (no model weights are made)."""
    from repro_torch.core.layout import global_batch_arrays
    from repro_torch.launch import train as train_launcher

    _, loader = train_launcher.build(train_launcher.parser().parse_args(TRAIN_ARGS))
    first = next(iter(loader.epoch(0)))
    return global_batch_arrays(first.batches, loader.layout)["segments"]


def bwd_case(rng, seg, dtype):
    """Inputs of one backward call: q, k, v, seg, and the forward's out and
    lse (from K1), and a cotangent do."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v, seg_t = make_case(rng, seg, dtype)
    blk = fa.select_block(seg.shape[1], 128)
    out, lse = fa.segment_flash_attention(q, k, v, seg_t, block_q=blk, block_kv=blk, return_lse=True)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to("cuda", dtype)
    return (q, k, v, seg_t, out, lse, do), blk


def phase_backward(rng, train_seg):
    """K2/K3 and K5/K6 against the plain backward, the two bit-exact pairs,
    and exactly zero gradients on all-padding rows."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import segment_flash_attention_bwd_ref

    max_err = {name: 0.0 for pair in BWD_PAIRS for name in pair}
    cases = [packed_segments(rng, rows, cap) for rows, cap in SHAPES]
    cases += [train_seg, packed_segments(rng, 3, 200)]  # the training step; block 40
    for seg_np in cases:
        rows, cap = seg_np.shape
        for tname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            args, blk = bwd_case(rng, seg_np, dtype)
            kw = dict(block_q=blk, block_kv=blk)
            dense = fa.segment_flash_attention_bwd(*args, **kw)
            pruned = fa.segment_flash_attention_bwd_pruned(*args, **kw)
            plain = segment_flash_attention_bwd_ref(*args)
            torch.cuda.synchronize()
            valid, tol = args[3] > 0, TOL[tname]
            # The dQ pass writes dq, the dK/dV pass dk and dv.
            for (dense_name, pruned_name), outputs in zip(BWD_PAIRS, ((0,), (1, 2))):
                errs = []
                for i in outputs:
                    a, b, ref = dense[i], pruned[i], plain[i]
                    check(torch.equal(a, b), f"{pruned_name} not bit-exact vs {dense_name} "
                                             f"at {(rows, cap)} {tname}")
                    check(bool(torch.all(a[~valid] == 0)),
                          f"{dense_name} output {i} not zero on padding rows at {(rows, cap)} {tname}")
                    ok = torch.allclose(a[valid].float(), ref[valid].float(), atol=tol, rtol=tol)
                    errs.append((a[valid].float() - ref[valid].float()).abs().max().item())
                    check(ok, f"{dense_name} output {i} vs plain at {(rows, cap)} {tname}: err {errs[-1]}")
                if tname == "bfloat16":
                    for name in (dense_name, pruned_name):
                        max_err[name] = max(max_err[name], max(errs))
                print(f"[backward] {dense_name} == {pruned_name} bit-exact rows={rows} cap={cap} block={blk} "
                      f"{tname}: max_abs_err vs plain {max(errs):.3g} (tol {tol}), padding rows zero")
            del args, dense, pruned, plain
    torch.cuda.empty_cache()
    return max_err


def record_prefill(engine, sink: list) -> None:
    """Keep every prefill call's picked logits (the engine discards them)."""
    lookup = engine._prefill_fn

    def wrapped(shape):
        fn = lookup(shape)

        def call(*args):
            picked, caches = fn(*args)
            sink.append(picked.detach().clone())
            return picked, caches

        return call

    engine._prefill_fn = wrapped


def profile_run(run, tag: str, unit: str) -> None:
    """Where the time goes: the card's kernel time against the wall clock of
    the same work (``run`` returns how many ``unit``s it did), and the
    kernels that take most of it, under ``torch.profiler`` (which adds host
    overhead, so the busy share it gives is a lower bound for the unprofiled
    run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        units = run()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] the profiler recorded no device events: device busy share not measured")
        return
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    print(f"[{tag}] profile: wall {wall_ms:.1f} ms, device kernel time {busy_ms:.1f} ms, busy share "
          f"{busy_ms / wall_ms:.3f}, {len(kernels)} kernels ({len(kernels) / units:.0f} per {unit} "
          f"over {units} {unit}s)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms:8.2f} ms  {name[:100]}")


def phase_serving():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import LM
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3_0_6b")
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f}s")
    serve_cfg = ServeConfig(num_slots=8, max_len=256, l_max=1024, lookahead=32)
    trace = synth_request_trace(24, vocab=cfg.vocab_size, prompt_min=8, prompt_max=96,
                                new_min=2, new_max=48, seed=0)

    def serve(model_, picked=None):
        engine = ContinuousBatchingEngine(model_, params, serve_cfg)
        if picked is not None:
            record_prefill(engine, picked)
        rids = [engine.submit(p, n) for p, n in trace]
        t = time.perf_counter()
        outputs = engine.run()
        torch.cuda.synchronize()
        return engine, rids, outputs, time.perf_counter() - t

    serve(model)  # warm-up: cuBLAS handles, the kernel library, allocator pools
    torch.cuda.reset_peak_memory_stats()
    picked: list = []
    fa.reset_launches()
    engine, rids, outputs, wall = serve(model, picked)
    launches = dict(fa.LAUNCHES)
    st = engine.stats
    check(st.finished == len(trace) and len(outputs) == len(trace),
          f"{st.finished}/{len(trace)} requests finished")
    check(launches["segment_flash_attention_pruned"] == st.prefill_calls * cfg.n_layers,
          f"K4 launches {launches} != prefill_calls {st.prefill_calls} x {cfg.n_layers}")
    check(launches["segment_flash_attention"] == 0, f"K1 launched on the pruned route: {launches}")
    lat = np.array([engine.requests[r].latency_s for r in rids])
    ttft = np.array([engine.requests[r].first_token_s - engine.requests[r].submitted_s for r in rids])
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] tokens/s {st.generated_tokens / wall:.1f} ({st.generated_tokens} tokens in "
          f"{wall:.3f}s), decode steps {st.decode_steps}, prefill calls {st.prefill_calls}, "
          f"slot occupancy {st.slot_decode_occupancy:.3f}, latency p50/p99 "
          f"{1e3 * np.percentile(lat, 50):.1f}/{1e3 * np.percentile(lat, 99):.1f} ms, ttft p50 "
          f"{1e3 * np.percentile(ttft, 50):.1f} ms, max_memory_allocated {peak / 2**30:.3f} GiB")
    print(f"[serve] launches {launches}, prefill buckets {dict(engine.prefill_traces)}, "
          f"decode shapes {engine.decode_traces}, ticks {st.ticks} ({1e3 * wall / st.ticks:.2f} ms each)")

    def first_ticks(n: int = 8):
        fresh = ContinuousBatchingEngine(model, params, serve_cfg)
        for p, n_new in trace:
            fresh.submit(p, n_new)
        for _ in range(n):
            fresh.tick()
        torch.cuda.synchronize()
        return fresh.stats.ticks

    profile_run(first_ticks, "serve", "tick")

    fa.reset_launches()
    dense_model = LM(dataclasses.replace(cfg, attn_grid="dense"))
    dense_engine, dense_rids, dense_out, dense_wall = serve(dense_model)
    dense_launches = dict(fa.LAUNCHES)
    check(all(np.array_equal(outputs[a], dense_out[b]) for a, b in zip(rids, dense_rids)),
          "the dense kernel route generated other ids than the pruned route")
    check(dense_launches["segment_flash_attention"] == dense_engine.stats.prefill_calls * cfg.n_layers
          and dense_launches["segment_flash_attention_pruned"] == 0,
          f"dense route launches {dense_launches}")
    print(f"[serve] dense route: identical ids for {len(trace)} requests, launches {dense_launches}, "
          f"tokens/s {dense_engine.stats.generated_tokens / dense_wall:.1f}")

    # The plain route (blockwise masked attention in bf16) for one tick: the
    # first prefill sees the same cohort as the kernel route's first prefill.
    plain_engine = ContinuousBatchingEngine(LM(dataclasses.replace(cfg, attn_impl="xla")), params, serve_cfg)
    plain_picked: list = []
    record_prefill(plain_engine, plain_picked)
    for p, n in trace:
        plain_engine.submit(p, n)
    plain_engine.tick()
    a, b = picked[0].float(), plain_picked[0].float()
    live = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for request in plain_engine.requests.values():
        if request.slot is not None:  # admitted by the first prefill
            live[request.slot] = True
    err = (a[live] - b[live]).abs().max().item()
    scale = b[live].abs().max().item()
    same_first = torch.equal(a[live].argmax(-1), b[live].argmax(-1))
    print(f"[serve] first prefill picked logits, kernel vs plain route: max_abs_err {err:.4g} "
          f"(logit scale {scale:.4g}), same first tokens {same_first}")
    check(torch.allclose(a[live], b[live], atol=TOL["bfloat16"] * max(scale, 1.0), rtol=TOL["bfloat16"]),
          f"kernel vs plain route first prefill logits differ by {err}")
    # Each kernel's launches on its own route: K4 on the default (pruned)
    # route, K1 on the attn_grid="dense" route of the same prefill.
    return {
        "segment_flash_attention": dense_launches["segment_flash_attention"],
        "segment_flash_attention_pruned": launches["segment_flash_attention_pruned"],
    }


def train_run(grid: str, profile_steps: int = 0) -> dict:
    """TRAIN_STEPS steps of the train launcher's trainer on ``--attn-grid
    grid`` from seed-0 weights; the kernels' launches are counted from 0 just
    before the run and read just after it."""
    import math

    import torch

    from repro_torch import obs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(
        TRAIN_ARGS + ["--attn-grid", grid]))
    cfg = trainer.model.cfg
    t0 = time.perf_counter()
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[train] {cfg.name} grid={grid}: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f}M params {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f}s")
    reg, tracer = obs.default_registry(), obs.default_tracer()
    reg.reset()
    tracer.reset()
    tracer.enable()  # the trainer then syncs the card at the end of each step
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    state, steps = trainer.train_epoch(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    tracer.disable()
    step_s = [e["dur"] / 1e6 for e in tracer.events() if e["name"] == "train/step"]
    tokens = reg.flat()["train_tokens_total"]
    peak = torch.cuda.max_memory_allocated()
    check(steps == TRAIN_STEPS and len(trainer.history) == steps, f"{steps} steps run")
    for rec in trainer.history:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"step {rec['step']} on grid {grid}: loss {rec['loss']} grad_norm {rec['grad_norm']}")
        print(f"[train] grid={grid} {Trainer.format_log_line(rec)}")
    n = cfg.n_layers * steps
    fwd, dq, dkv = (("segment_flash_attention_pruned", "segment_flash_attention_bwd_pruned_dq",
                     "segment_flash_attention_bwd_pruned_dkv") if grid == "pruned" else
                    ("segment_flash_attention", "segment_flash_attention_bwd_dq",
                     "segment_flash_attention_bwd_dkv"))
    want = {**dict.fromkeys(launches, 0), fwd: 2 * n, dq: n, dkv: n}
    check(launches == want, f"grid {grid}: launches {launches} != {want}")
    print(f"[train] grid={grid}: launches {launches} ({steps} steps x {cfg.n_layers} layers; "
          f"remat runs the forward twice)")
    loss_tokens = [rec["tokens"] for rec in trainer.history]
    print(f"[train] grid={grid}: tokens/s {tokens / wall:.1f} ({tokens:.0f} real tokens in {wall:.3f}s), "
          f"step s {[round(t, 3) for t in step_s]}, loss tokens/s over steps 2..{steps} "
          f"{sum(loss_tokens[1:]) / sum(step_s[1:]):.1f}, max_memory_allocated {peak / 2**30:.3f} GiB")
    if profile_steps:
        more = Trainer(trainer.model, loader, trainer.opt_cfg,
                       TrainerConfig(log_every=profile_steps, max_steps=profile_steps))

        def run():
            more.train_epoch(state)
            torch.cuda.synchronize()
            return profile_steps

        profile_run(run, "train", "step")
    return dict(launches=launches, losses=[r["loss"] for r in trainer.history],
                grad_norms=[r["grad_norm"] for r in trainer.history], step_s=step_s,
                tokens_per_s=tokens / wall, peak_gib=peak / 2**30)


def phase_training() -> dict:
    """Full-width training on the default (pruned) route, then on the dense
    route from the same weights and data; returns the kernels' launches, each
    from its own route's run."""
    import torch

    pruned = train_run("pruned", profile_steps=2)
    torch.cuda.empty_cache()
    dense = train_run("dense")
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(pruned["losses"], dense["losses"])):
        check(abs(a - b) <= LOSS_RTOL * abs(b), f"step {i + 1}: loss {a} (pruned) vs {b} (dense)")
    print(f"[train] dense vs pruned route per-step losses {pruned['losses']} vs {dense['losses']} "
          f"(rtol {LOSS_RTOL}); grad_norm {pruned['grad_norms']} vs {dense['grad_norms']}")
    launches = {name: dense["launches"][name] for name in KERNELS if KERNELS[name][2] == "dense"}
    launches.update({name: pruned["launches"][name] for name in KERNELS if KERNELS[name][2] == "pruned"})
    return launches


def sdpa_inputs(q, k, v, seg):
    """The SDPA yardstick's (B, H, S, D) layout, kv heads repeated, and the
    same visibility as a boolean mask (rows with no visible key are padding)."""
    import torch

    cap = q.shape[1]
    pos = torch.arange(cap, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None] & (seg[:, :, None] == seg[:, None, :])
            & (seg[:, None, :] > 0))[:, None]
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    return qt, kt, vt, mask


def phase_times(rng, launches: dict):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_ref

    rows_out = []
    for rows, cap in SHAPES:
        blk = fa.select_block(cap, 128)
        q, k, v, seg = make_case(rng, packed_segments(rng, rows, cap), torch.bfloat16)
        tables = build_liveness_tables(seg, block_q=blk, block_kv=blk)
        live = int(tables.kv_count.sum()) * HEADS
        flops = 4.0 * blk * blk * D_HEAD * live
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v read, out written
        bound_s = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES else "bytes"
        kw = dict(block_q=blk, block_kv=blk)
        t_k1 = cuda_ms(lambda: fa.segment_flash_attention(q, k, v, seg, **kw))
        t_k4 = cuda_ms(lambda: fa.segment_flash_attention_pruned(q, k, v, seg, tables=tables, **kw))
        t_plain = cuda_ms(lambda: segment_flash_attention_ref(q, k, v, seg))
        qt, kt, vt, mask = sdpa_inputs(q, k, v, seg)
        t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        row = dict(rows=rows, cap=cap, block=blk, live_tiles=live, flops=flops, bytes=nbytes,
                   bound_ms=1e3 * bound_s, bound_by=bound_by, k1_ms=t_k1, k4_ms=t_k4,
                   plain_ms=t_plain, library_ms=t_lib)
        rows_out.append(row)
        for name, t in (("segment_flash_attention", t_k1), ("segment_flash_attention_pruned", t_k4)):
            print(f"[times] {name} rows={rows} cap={cap} bf16: kernel_ms {t:.4f} plain_ms "
                  f"{t_plain:.4f} library_ms {t_lib:.4f} bound_ms {1e3 * bound_s:.5f} ({bound_by}) "
                  f"live tiles {live} launches {launches[name]} (serving run, all shapes)")
    return rows_out


def phase_times_training(rng, train_seg) -> dict:
    """Every kernel at the first training step's shape (bf16): each pass of
    the backward alone through its C entry point, the plain version, the
    SDPA yardstick (its forward for K1/K4, its backward for the backward
    kernels) and the bound (live tiles' FLOPs at 4, 6 or 8 bq.bkv.D for the
    forward, dQ and dK/dV; each input read once, each output written once)."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_bwd_ref, segment_flash_attention_ref

    (q, k, v, seg, out, lse, do), blk = bwd_case(rng, train_seg, torch.bfloat16)
    rows, cap = train_seg.shape
    tables = build_liveness_tables(seg, block_q=blk, block_kv=blk)
    live = int(tables.kv_count.sum()) * HEADS  # live (row, q-head, tile) triples
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = build.load_library("flash_bwd")
    dims = (rows, cap, HEADS, KV_HEADS, D_HEAD, blk, blk, 1, 1.0 / D_HEAD**0.5,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    ptr = fa._ptr
    head = (1, 0, ptr(q), ptr(k), ptr(v), ptr(seg))  # bf16 on device 0
    resid = (ptr(do), ptr(lse), ptr(delta))
    calls = {
        "segment_flash_attention_bwd_dq": head + resid + (ptr(dq),),
        "segment_flash_attention_bwd_dkv": head + resid + (ptr(dk), ptr(dv)),
        "segment_flash_attention_bwd_pruned_dq":
            head + (ptr(tables.kv_idx), ptr(tables.kv_count)) + resid + (ptr(dq),),
        "segment_flash_attention_bwd_pruned_dkv":
            head + (ptr(tables.q_idx), ptr(tables.q_count)) + resid + (ptr(dk), ptr(dv)),
    }

    def launch(name):
        rc = getattr(lib, KERNELS[name][3])(*calls[name], *dims)
        check(rc == 0, f"{name}: CUDA error {rc}")

    elem = rows * cap * D_HEAD  # elements of one head's (rows, cap, D) slab
    qo_bytes, kv_bytes = 2 * elem * HEADS, 2 * elem * KV_HEADS
    stat_bytes = 4 * rows * cap * HEADS  # one fp32 (rows, cap, H) statistic
    seg_bytes = 4 * rows * cap
    work = {  # name -> (FLOPs, bytes read once + written once)
        "fwd": (4.0 * blk * blk * D_HEAD * live, 2 * qo_bytes + 2 * kv_bytes + stat_bytes + seg_bytes),
        "dq": (6.0 * blk * blk * D_HEAD * live, 3 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes),
        "dkv": (8.0 * blk * blk * D_HEAD * live, 2 * qo_bytes + 4 * kv_bytes + 2 * stat_bytes + seg_bytes),
    }
    qt, kt, vt, mask = sdpa_inputs(q, k, v, seg)
    t_lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters=10)
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_do = do.transpose(1, 2).contiguous()
    t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True),
                        iters=5, warmup=1)
    del lib_out, qt, kt, vt, mask
    t_plain_fwd = cuda_ms(lambda: segment_flash_attention_ref(q, k, v, seg, return_lse=True),
                          iters=3, warmup=1)
    t_plain_bwd = cuda_ms(lambda: segment_flash_attention_bwd_ref(q, k, v, seg, out, lse, do),
                          iters=3, warmup=1)
    torch.cuda.empty_cache()
    kw = dict(block_q=blk, block_kv=blk, return_lse=True)
    timed = {
        "segment_flash_attention": ("fwd", lambda: fa.segment_flash_attention(q, k, v, seg, **kw)),
        "segment_flash_attention_pruned": ("fwd", lambda: fa.segment_flash_attention_pruned(
            q, k, v, seg, tables=tables, **kw)),
        **{name: ("dq" if name.endswith("_dq") else "dkv", lambda name=name: launch(name))
           for pair in BWD_PAIRS for name in pair},
    }
    result = {}
    for name, (kind, fn) in timed.items():
        ms = cuda_ms(fn, iters=5, warmup=1)
        flops, nbytes = work[kind]
        bound_by = "operations" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES else "bytes"
        result[name] = dict(
            ms=ms, bound_ms=1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES), bound_by=bound_by,
            plain_ms=t_plain_fwd if kind == "fwd" else t_plain_bwd,
            library_ms=t_lib_fwd if kind == "fwd" else t_lib_bwd, flops=flops, bytes=nbytes,
        )
        r = result[name]
        print(f"[times] {name} rows={rows} cap={cap} block={blk} bf16 (training step 1): kernel_ms "
              f"{ms:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.5f} ({bound_by}) live tiles {live} "
              f"achieved {flops / ms / 1e9:.2f} TFLOP/s")
    return dict(result, shape=[rows, cap, HEADS, KV_HEADS, D_HEAD], block=blk, live_tiles=live)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout")
    if os.environ.get("PYTHONHASHSEED") != "0":
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False  # every reference here is full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, count = phase_device()
    phase_build()
    max_err = phase_parity(np.random.default_rng(0))
    train_seg = training_segments()
    max_err.update(phase_backward(np.random.default_rng(2), train_seg))
    serve_launches = phase_serving()
    train_launches = phase_training()
    serve_times = phase_times(np.random.default_rng(1), serve_launches)[-1]  # (8, 256)
    times = phase_times_training(np.random.default_rng(3), train_seg)
    kernels = []
    for kname, (source, replaces, grid, _) in KERNELS.items():
        t = times[kname]
        entry = dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=train_launches[kname], max_abs_err=max_err[kname],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=times["shape"], dtype="bfloat16",
            launches_note=f"{TRAIN_STEPS} training steps on attn_grid={grid}",
        )
        if kname in serve_launches:
            entry.update(
                launches_serving=serve_launches[kname],
                serving_ms=serve_times["k1_ms" if grid == "dense" else "k4_ms"],
                serving_shape=[serve_times["rows"], serve_times["cap"], HEADS, KV_HEADS, D_HEAD],
            )
        kernels.append(entry)
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
