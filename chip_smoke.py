#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in the checkout, then runs:

1. device   — the card's name and power limit (``nvidia-smi``), device count;
2. parity   — the dense kernel (K1) and the pruned kernel (K4) at the serving
              shapes, (rows, capacity) in {(1,64), (2,128), (6,128), (8,256)}
              with 16 q heads over 8 kv heads, d_head 128, held against the
              plain PyTorch version on valid rows (bf16: atol = rtol = 2e-2;
              fp32: 2e-5; lse in fp32 at 2e-5), K4 against K1 with
              ``torch.equal``, and the liveness tables built on the card
              against the same tables built on the CPU;
3. serving  — ``ContinuousBatchingEngine`` on full-width Qwen3-0.6B in bf16
              (random weights from seed 0) with the launcher's defaults; every
              request must finish, K4 must launch 28 times per prefill call and
              K1 never; the same trace on the dense kernel must give the
              identical ids; the first prefill's picked logits on the kernel
              route are held against the plain route's; ``torch.profiler``
              reads the card's busy share over the first eight ticks;
4. times    — K1, K4, the plain version and ``scaled_dot_product_attention``
              (a yardstick only: the port never calls it) at each shape;
5. kernels  — one JSON line with every ported kernel.

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.  It
needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import dataclasses
import json
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
KERNELS = {
    "segment_flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:211",
    ),
    "segment_flash_attention_pruned": dict(
        source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:622",
    ),
}


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


def make_case(rng, rows, cap, dtype):
    import numpy as np
    import torch

    seg = torch.from_numpy(packed_segments(rng, rows, cap)).cuda()
    qkv = [
        torch.from_numpy(rng.standard_normal((rows, cap, n, D_HEAD), dtype=np.float32)).to("cuda", dtype)
        for n in (HEADS, KV_HEADS, KV_HEADS)
    ]
    return (*qkv, seg)


def phase_parity(rng):
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_ref

    max_err = {name: 0.0 for name in KERNELS}
    for rows, cap in SHAPES:
        blk = fa.select_block(cap, 128)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, seg = make_case(rng, rows, cap, dtype)
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


def profile_run(run) -> None:
    """Where serving time goes: the card's kernel time against the wall clock
    of the same ticks (the first eight of a fresh engine: one prefill of the
    first cohort, then decode), and the kernels that take most of it, under
    ``torch.profiler`` (which adds host overhead, so the busy share it gives
    is a lower bound for the unprofiled run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine = run()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler recorded no device events: device busy share not measured")
        return
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    ticks = engine.stats.ticks
    print(f"[profile] wall {wall_ms:.1f} ms, device kernel time {busy_ms:.1f} ms, busy share "
          f"{busy_ms / wall_ms:.3f}, {len(kernels)} kernels ({len(kernels) / ticks:.0f} per tick "
          f"over {ticks} ticks)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {ms:8.2f} ms  {name[:100]}")


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
        return fresh

    profile_run(first_ticks)

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


def phase_times(rng, launches: dict):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_ref

    rows_out = []
    for rows, cap in SHAPES:
        blk = fa.select_block(cap, 128)
        q, k, v, seg = make_case(rng, rows, cap, torch.bfloat16)
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
        # SDPA yardstick: (B, H, S, D) layout, kv heads repeated, the same
        # visibility as a boolean mask; rows with no visible key are padding.
        pos = torch.arange(cap, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])[None] & (seg[:, :, None] == seg[:, None, :])
                & (seg[:, None, :] > 0))[:, None]
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(HEADS // KV_HEADS, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(HEADS // KV_HEADS, dim=2).transpose(1, 2).contiguous()
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout")
    import numpy as np

    name, count = phase_device()
    phase_build()
    max_err = phase_parity(np.random.default_rng(0))
    launches = phase_serving()
    times = phase_times(np.random.default_rng(1), launches)
    head = times[-1]  # the widest serving shape, (8, 256)
    kernels = []
    for kname, info in KERNELS.items():
        kernels.append(dict(
            name=kname, route="cuda", source=info["source"], replaces=info["replaces"],
            launches=launches[kname], max_abs_err=max_err[kname],
            ms=head["k1_ms" if kname == "segment_flash_attention" else "k4_ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            shape=[head["rows"], head["cap"], HEADS, KV_HEADS, D_HEAD], dtype="bfloat16",
            parity="pass: vs plain (bf16 2e-2, fp32 2e-5) and K4 == K1 bit-exact",
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
