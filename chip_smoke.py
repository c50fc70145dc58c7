#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in the checkout (one ``nvcc`` per
source, in parallel; the tensor-core kernels must show 0 spill bytes in
``ptxas -v``), then runs:

1. device    — the card's name and power limit (``nvidia-smi``), device count;
2. parity    — the forward kernels, dense (K1) and pruned (K4), at the serving
               shapes, (rows, capacity) in {(1,64), (2,128), (6,128), (8,256)}
               with 16 q heads over 8 kv heads, d_head 128, and at the
               backward's extra shapes (the first training step's, block 40
               at 3 x 200, a peaked softmax at 2 x 1024, a GQA group of 8,
               d_head 64 at 3 x 96), in fp32 (the CUDA-core route) and bf16
               (the tensor-core route): held against the plain PyTorch
               version on valid rows (bf16: atol = rtol = 2e-2; fp32: 2e-5;
               lse in fp32 at 2e-5 in both), K4 against K1 with
               ``torch.equal``, exactly zero output on all-padding rows, and
               the liveness tables built on the card against the same tables
               built on the CPU;
3. backward  — the four backward kernels, dQ and dK/dV of the dense (K2, K3)
               and pruned (K5, K6) grids, at the serving shapes, at the first
               training step's packed shape, at S = 200 (block 40), with a
               peaked softmax (q x 4 at 2 x 1024: P near one-hot and large
               dS terms that cancel in dK, where the bf16 kernels' rounding
               of P and scale.dS costs most), with a GQA
               group of 8 (16 q heads over 2 kv heads, 2 x 512) and at d_head
               64 (3 x 96, block 96), in bf16 and fp32: each against the
               plain backward on valid rows at the tolerances above (each
               case's worst error printed as a share of what allclose
               allows), K5 == K2 and K6 == K3 with ``torch.equal``, and
               exactly zero gradients on all-padding rows;
4. serving   — ``ContinuousBatchingEngine`` on full-width Qwen3-0.6B in bf16
               (random weights from seed 0) with the launcher's defaults; every
               request must finish, K4 must launch 28 times per prefill call and
               K1 never; the same trace on the dense kernel must give the
               identical ids; the first prefill's picked logits on the kernel
               route are held against the plain route's; ``torch.profiler``
               reads the card's busy share over the first eight ticks;
5. training  — ``Trainer`` on full-width Qwen3-0.6B in bf16 (random weights
               from seed 0) through the train launcher
               (``--layout packed --world 2 --l-max 4096``, TRAIN_STEPS steps)
               on three data paths of the pruned route: the launcher's
               default (the streaming executor with a prefetch thread),
               ``--eager``, and ``--num-workers 2 --device-put`` (two worker
               processes, the step arrays staged on the card from the
               producer on a CUDA stream of its own): finite loss and
               grad_norm every step, per step K4 launched 2 x 28 times
               (remat recomputes the forward), K5 and K6 28 times, K1-K3
               never; the sha256 of each step's host arrays equal across the
               paths and the per-step losses within LOSS_RTOL; the same steps
               on ``attn_grid="dense"`` launch K1 2 x 28, K2 and K3 28 times
               per step, K4-K6 never, with the same digests and losses; per
               run tokens/s (and over steps 2..4, which leave out the first
               step's warm-up and the data path's drain after the last),
               step time, per-step ``train/realize``, ``train/pad`` and
               ``train/device_put`` seconds, the prefetch thread's hits,
               misses and wait, the worker pool's counts, peak memory;
               ``torch.profiler``'s busy share over two default-path steps;
6. ssd       — the SSD chunk-scan kernel (K7) against its plain chunked
               version, y and the final state, at the JAX package's sweep
               shapes and at the full-width (2, 2048, 24, 64, 128, 256) on
               the column views the model passes, from a zero and a random
               initial state, in fp32 (the CUDA-core loop; atol 1e-4, rtol
               1e-3) and bf16 (the chunk-parallel tensor-core passes; 2e-2),
               each case's worst error printed as a share of its allowance,
               and the sha256 of the fp32 route's outputs over its cases (equal
               across two trees means bit-identical outputs);
               once against the sequential recurrence in fp32;
7. ssd_grad  — the SSD's autograd Function (``kernels/ops.ssd_chunked_scan``
               under grad: K7 forward, the plain chunked form's gradient
               backward) against plain autograd through the plain version,
               at the JAX sweep shapes and at the full-width (2, 2048, 24, 64,
               128, 256) with dt and a drawn from mamba2's init (dt_bias 0,
               a over [-1, -16]: exp(acs_i - acs_j) overflows fp32 above the
               diagonal), on the column views the model passes, in fp32 (2e-5)
               and bf16 (2e-2): y at the SSD tolerance, the gradients of x, B,
               C (one tensor), dt and a, each case's worst error printed as a
               share of its allowance, every gradient finite, one K7 launch;
8. ssm       — full-width mamba2-130m in bf16 (random weights from seed 0):
               ``LM.prefill`` of 8 prompts x 2048 tokens (K7 must launch 24
               times) and 32 greedy ``LM.decode_step``s (K7 never); prefill
               ms, decode ms per step, tokens/s, peak memory and
               ``torch.profiler``'s busy share.  The fp32 rail at 2 x 512:
               teacher-forced decode equals the full forward at 2e-3, and the
               card's prefill logits equal the CPU port's at 1e-3;
9. ssm_train — ``Trainer`` on full-width mamba2-130m in bf16 (random weights
               from seed 0) through the train launcher (``--arch mamba2_130m
               --layout dense --world 2 --l-max 4096``, SSM_TRAIN_STEPS steps):
               finite loss and grad_norm every step, K7 launched 2 x 24 times
               per step (remat recomputes the forward); tokens/s over steps
               2..4, step time, peak memory; over two more steps the device
               time of the forward, the backward (remat's recompute included)
               and the optimizer, and of the SSD backward (the plain form's
               gradient) inside the backward, from CUDA events; then
               ``torch.profiler``'s busy share and largest kernels over two
               more;
10. resume   — the same trainer with a checkpoint every two steps (keep two)
               for four steps into a directory under ``build/`` that is
               removed at the end: a fresh trainer's ``restore_or_init``
               restores step 4 with every leaf ``torch.equal`` to the first
               run's state and trains two more steps with finite losses; save
               and restore seconds and bytes; then the launcher's restart
               loop with ``--checkpoint-dir`` on the smoke config for 20 steps
               (the launcher saves every 20, as the JAX launcher does) must
               leave ``latest.json`` at step 20 and a readable
               ``step_00000020.npz``;
11. dp_train — Eq. 2 data-parallel training (``train/trainer.dp_step``) on
               full-width Qwen3-0.6B in bf16 (random weights from seed 0),
               the dense layout at ``--world 2 --l-max 4096`` on the flash
               route (K1 forward twice per layer with remat, K2 and K3
               backward), DP_STEPS steps: the single-process ``Trainer`` on
               the same steps is the reference; ``dp_step`` at world 1 over
               NCCL in this process, then at world 2 over gloo in two
               spawned ranks sharing the card, each on its own rows of every
               step, exact and then bf16-compressed gradients: per step the
               ranks gather the step's sha256 through
               ``ResilientCollective(TorchProcessCollective)`` under a
               deadline (equal to each other's and to the reference's), loss
               and grad_norm within DP_RTOL of the reference (the compressed
               loss within DP_RTOL and its grad_norm within DP_COMP_RTOL of
               the exact run's), rank 0's parameters
               ``torch.equal`` to rank 1's after every step, K1 2 x 28, K2
               and K3 28 launches per step and rank; step time and peak
               memory per rank;
12. probes   — the measured block probe (``kernels/autotune.py``) at the
               first training step's shape on the dense and pruned grids and
               at the packed run's (2, 4096) on the pruned grid, in bf16
               (each candidate's median ms over its windows and their spread,
               the pick, a second call served from the cache); the train
               launcher with ``--attn-autotune
               --telemetry DIR --telemetry-port 0`` for PROBE_STEPS steps on
               ``--layout packed --world 2 --l-max 4096`` (finite losses,
               metrics.json, trace.json and rounds.json written, a GET
               /metrics during the run answering 200 with a counted step;
               K4-K6 counted over the run, the probes included); the train
               launcher's ``--layout auto --calibration-steps 6`` (both
               layouts' steps/s and the choice);
13. times     — K1, K4 at the serving shapes and K2, K3, K5, K6 at the first
               training step's shape: the kernel, the plain version,
               ``scaled_dot_product_attention`` and its backward with the same
               boolean mask (a yardstick only: the port never calls it), and
               the bound, each kernel's share of its bound and its ratio to
               the yardstick; K7 at (8, 2048), (1, 32768) and the first SSM
               training step's (2, 6144) in bf16 beside its
               plain version and its bound (no PyTorch call computes the SSD),
               with its device kernels per call and their times under
               ``torch.profiler`` (a bf16 call must launch four), its bound share
               and its scratch bytes (peak allocated during one call, less y
               and the final state);
14. kernels  — one JSON line with every ported kernel.

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.  It
needs a CUDA device and the repository around it.  It pins PYTHONHASHSEED
to 0 (re-executing itself once) because the data path's synthetic dataset
hashes tuples, so the training shapes are the same in every run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
# Per-step losses of the training runs (two routes, three data paths): the
# kernels of the two routes are bit-exact pairs and the data paths deliver
# the same arrays, so only the order of atomic adds outside the kernels (the
# embedding gradient) differs; bf16 weights.
LOSS_RTOL = 1e-2
# The pruned route's training runs: name -> the train launcher's data-path
# flags.  The first is the launcher's default and takes the profile.
DATA_PATHS = {
    "stream+prefetch": [],
    "eager": ["--eager"],
    "workers+device-put": ["--num-workers", "2", "--device-put"],
}
STEP_PHASES = ("train/realize", "train/pad", "train/device_put")
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
# The SSD kernel (K7).  (B, S, H, P, N, chunk): the JAX package's sweep
# (tests/test_kernels.py), then mamba2-130m's widths.
SSD = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:86"
SSD_SWEEP = ((1, 64, 1, 8, 16, 16), (2, 128, 3, 8, 16, 32), (1, 256, 2, 16, 32, 64),
             (2, 96, 4, 8, 8, 32))
SSD_FULL = (2, 2048, 24, 64, 128, 256)
SSD_TOL = {"float32": dict(atol=1e-4, rtol=1e-3), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# (B, S) at full width, bf16: the ssm phase's prefill, one long sequence, and
# the ssm_train phase's first step (the SSD of every layer's forward)
SSD_TIMES = ((8, 2048), (1, 32768), (2, 6144))
SSD_BF16_KERNELS = 4  # device kernels of one bf16 K7 call: scores, chunk states, state pass, outputs
SSM_ROWS, SSM_PROMPT, SSM_DECODE = 8, 2048, 32  # the ssm phase's prefill and decode
SSM_RAIL = (2, 512, 384)  # fp32 rail: rows, tokens, prefill length before teacher forcing
# The SSM training run: the train launcher's flags (steps of 2 x 3072 to
# 2 x 6144 token slots).
SSM_TRAIN_STEPS = 4
SSM_TRAIN_ARGS = ["--arch", "mamba2_130m", "--layout", "dense", "--world", "2", "--l-max", "4096",
                  "--steps", str(SSM_TRAIN_STEPS), "--log-every", "1"]
# The launcher run of the resume phase: the smoke config, long enough for
# the launcher's first checkpoint.
# The ssm_train phase's record_function ranges around a step's phases.
RANGE_PREFIX = "ssm_train/"
# The dp_train phase: the train launcher's flags for the data; the dense
# layout (dp_step takes tokens, labels and loss_mask) on the flash route.
DP_STEPS = 4
DP_ARGS = ["--arch", "qwen3_0_6b", "--layout", "dense", "--world", "2", "--l-max", "4096",
           "--steps", str(DP_STEPS), "--attn-impl", "flash", "--log-every", "1"]
DP_RTOL = 2e-2  # per-step loss and grad_norm against the single process (bf16 weights)
DP_COMP_RTOL = 1e-2  # per-step grad_norm of the bf16-compressed reduce against the exact one
# The probes phase's training run and layout calibration.
PROBE_STEPS = 3
PROBE_TRAIN_ARGS = [*TRAIN_ARGS[:TRAIN_ARGS.index("--steps")], "--steps", str(PROBE_STEPS),
                    "--log-every", "1", "--attn-autotune"]
LAYOUT_AUTO_ARGS = ["--arch", "qwen3_0_6b", "--world", "2", "--l-max", "4096",
                    "--layout", "auto", "--calibration-steps", "6"]
RESUME_LAUNCHER_ARGS = ["--arch", "mamba2_130m", "--smoke", "--layout", "dense", "--world", "2",
                        "--l-max", "512", "--dataset", "uniform_narrow", "--data-scale", "0.05",
                        "--log-every", "20"]


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
    # The bf16 forward (K1/K4), dQ (K2/K5) and dK/dV (K3/K6) kernels, dense
    # and pruned, and K7's scores, chunk-state and output passes.
    spills = {fn: n for log in build.BUILD_LOGS.values()
              for fn, n in build.ptxas_spills(log).items() if "_tc_kernel" in fn}
    check(len(spills) == 9 and sum("ssd_" in fn for fn in spills) == 3 and not any(spills.values()),
          f"the tensor-core kernels must not spill: {spills}")
    print(f"[build] {len(spills)} tensor-core kernels, 0 spill bytes")


def make_case(rng, seg, dtype, heads=HEADS, kv_heads=KV_HEADS, d_head=D_HEAD):
    """q, k, v from the seed for the (rows, cap) numpy segment ids ``seg``."""
    import numpy as np
    import torch

    rows, cap = seg.shape
    qkv = [
        torch.from_numpy(rng.standard_normal((rows, cap, n, d_head), dtype=np.float32)).to("cuda", dtype)
        for n in (heads, kv_heads, kv_heads)
    ]
    return (*qkv, torch.from_numpy(seg).cuda())


def phase_parity(rng, train_seg):
    """K1 and K4 against the plain forward in both dtypes (out at the
    dtype's tolerance, lse at 2e-5), K4 == K1 bit for bit, exactly zero
    output on all-padding rows, and the liveness tables on the card against
    the CPU's."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_ref

    max_err = {"segment_flash_attention": 0.0, "segment_flash_attention_pruned": 0.0}
    cases = [("", packed_segments(rng, rows, cap), {}) for rows, cap in SHAPES]
    cases += [("training step", train_seg, {}), ("block 40", packed_segments(rng, 3, 200), {}),
              ("peaked q x4", packed_segments(rng, 2, 1024), dict(q_scale=4.0)),
              ("group 8", packed_segments(rng, 2, 512), dict(kv_heads=2)),  # 16 q heads over 2
              ("d_head 64", packed_segments(rng, 3, 96), dict(d_head=64))]  # block 96
    for label, seg_np, extra in cases:
        rows, cap = seg_np.shape
        blk = fa.select_block(cap, 128)
        widths = {key: val for key, val in extra.items() if key != "q_scale"}
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, seg = make_case(rng, seg_np, dtype, **widths)
            q = (q.float() * extra.get("q_scale", 1.0)).to(dtype)
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
                check(ok_out and ok_lse, f"{name} vs plain at {(rows, cap)} {label} {dname}: "
                                         f"out err {err}, lse err {lerr}")
                check(bool(torch.all(o[~valid] == 0)),
                      f"{name} output not zero on padding rows at {(rows, cap)} {label} {dname}")
                if dname == "bfloat16":
                    max_err[name] = max(max_err[name], err)
                print(f"[parity] {name} rows={rows} cap={cap} block={blk} heads={q.shape[2]}/{k.shape[2]} "
                      f"d_head={q.shape[3]}{' (' + label + ')' if label else ''} {dname}: "
                      f"max_abs_err out {err:.3g} lse {lerr:.3g} (tol {tol}, lse 2e-05), padding rows zero")
            check(torch.equal(o1, o4) and torch.equal(l1, l4),
                  f"K4 not bit-exact vs K1 at {(rows, cap)} {label} {dname}")
            print(f"[parity] K4 == K1 bit-exact rows={rows} cap={cap} {dname}")
            del q, k, v, o1, l1, o4, l4, ro, rl
        on_card = build_liveness_tables(seg, block_q=blk, block_kv=blk)
        on_cpu = build_liveness_tables(seg.cpu(), block_q=blk, block_kv=blk)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
              f"liveness tables differ between card and CPU at {(rows, cap)}")
        print(f"[parity] liveness tables card == cpu rows={rows} cap={cap} "
              f"live tiles {int(on_card.kv_count.sum())}/{rows * (cap // blk) ** 2}")
    torch.cuda.empty_cache()
    return max_err


def training_segments():
    """The segment ids of the training run's first step, from the train
    launcher's data path (no model weights are made)."""
    from repro_torch.core.layout import global_batch_arrays
    from repro_torch.launch import train as train_launcher

    _, loader = train_launcher.build(train_launcher.parser().parse_args(TRAIN_ARGS))
    first = next(iter(loader.epoch(0)))
    return global_batch_arrays(first.batches, loader.layout)["segments"]


def bwd_case(rng, seg, dtype, q_scale=1.0, **widths):
    """Inputs of one backward call: q (times ``q_scale``), k, v, seg, and the
    forward's out and lse (from K1), and a cotangent do; ``widths`` override
    make_case's heads, kv_heads and d_head."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v, seg_t = make_case(rng, seg, dtype, **widths)
    q = (q.float() * q_scale).to(dtype)
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
    cases = [("", packed_segments(rng, rows, cap), {}) for rows, cap in SHAPES]
    cases += [("training step", train_seg, {}), ("block 40", packed_segments(rng, 3, 200), {}),
              # P near one-hot, large dS terms cancelling in dK: bf16 rounding at its worst
              ("peaked q x4", packed_segments(rng, 2, 1024), dict(q_scale=4.0)),
              ("group 8", packed_segments(rng, 2, 512), dict(kv_heads=2)),  # 16 q heads over 2
              ("d_head 64", packed_segments(rng, 3, 96), dict(d_head=64))]  # block 96
    for label, seg_np, extra in cases:
        rows, cap = seg_np.shape
        for tname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            args, blk = bwd_case(rng, seg_np, dtype, **extra)
            kw = dict(block_q=blk, block_kv=blk)
            dense = fa.segment_flash_attention_bwd(*args, **kw)
            pruned = fa.segment_flash_attention_bwd_pruned(*args, **kw)
            plain = segment_flash_attention_bwd_ref(*args)
            torch.cuda.synchronize()
            valid, tol = args[3] > 0, TOL[tname]
            # The dQ pass writes dq, the dK/dV pass dk and dv.
            for (dense_name, pruned_name), outputs in zip(BWD_PAIRS, ((0,), (1, 2))):
                errs, shares = [], []
                for i in outputs:
                    a, b, ref = dense[i], pruned[i], plain[i]
                    check(torch.equal(a, b), f"{pruned_name} not bit-exact vs {dense_name} "
                                             f"at {(rows, cap)} {tname}")
                    check(bool(torch.all(a[~valid] == 0)),
                          f"{dense_name} output {i} not zero on padding rows at {(rows, cap)} {tname}")
                    ours, theirs = a[valid].float(), ref[valid].float()
                    ok = torch.allclose(ours, theirs, atol=tol, rtol=tol)
                    errs.append((ours - theirs).abs().max().item())
                    # the worst error as a share of what allclose allows there
                    shares.append(((ours - theirs).abs() / (tol + tol * theirs.abs())).max().item())
                    check(ok, f"{dense_name} output {i} vs plain at {(rows, cap)} {tname}: err {errs[-1]}")
                if tname == "bfloat16":
                    for name in (dense_name, pruned_name):
                        max_err[name] = max(max_err[name], max(errs))
                print(f"[backward] {dense_name} == {pruned_name} bit-exact rows={rows} cap={cap} block={blk} "
                      f"heads={args[0].shape[2]}/{args[1].shape[2]} d_head={args[0].shape[3]}"
                      f"{' (' + label + ')' if label else ''} {tname}: max_abs_err vs plain "
                      f"{max(errs):.3g} (tol {tol}; {max(shares):.3f} of the allowance), padding rows zero")
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


def is_kernel(e) -> bool:
    """A profiler event that is work on the card: not the device-side copy
    of one of this script's ``record_function`` ranges (named RANGE_PREFIX
    ...), which the profiler also lists among the device's events."""
    import torch

    return e.device_type() == torch.autograd.DeviceType.CUDA and not e.name().startswith(RANGE_PREFIX)


def profile_run(run, tag: str, unit: str) -> tuple | None:
    """Where the time goes: the card's kernel time against the wall clock of
    the same work (``run`` returns how many ``unit``s it did), and the
    kernels that take most of it, under ``torch.profiler`` (which adds host
    overhead, so the busy share it gives is a lower bound for the unprofiled
    run).  Returns the device ms by kernel name and the raw events, or None
    without device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        units = run()
        wall_ms = 1e3 * (time.perf_counter() - t)
    # The profiler's raw events: the kernels and durations that
    # ``prof.events()`` lists, without building its Python object for each
    # of the ~10^5 host ops of a training step (which takes seconds).
    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events if is_kernel(e)]
    if not kernels:
        print(f"[{tag}] the profiler recorded no device events: device busy share not measured")
        return None
    by_name: dict = {}
    for e in kernels:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    busy_ms = sum(by_name.values())
    print(f"[{tag}] profile: wall {wall_ms:.1f} ms, device kernel time {busy_ms:.1f} ms, busy share "
          f"{busy_ms / wall_ms:.3f}, {len(kernels)} kernels ({len(kernels) / units:.0f} per {unit} "
          f"over {units} {unit}s)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms:8.2f} ms  {name[:100]}")
    return by_name, events


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


def step_digest(loader_step, layout) -> str:
    """sha256 of one step's global host arrays: the pinned sources of the
    copies when the loader staged the step on the card, else the arrays the
    trainer assembles from the rank batches."""
    import numpy as np

    from repro_torch.core.layout import global_batch_arrays

    if loader_step.device is not None:
        arrays = {k: t.numpy() for k, t in loader_step.device.host.items()}
    else:
        arrays = global_batch_arrays(loader_step.batches, layout)
    h = hashlib.sha256()
    for key in sorted(arrays):
        h.update(key.encode())
        h.update(np.ascontiguousarray(arrays[key]).tobytes())
    return h.hexdigest()


def step_phases(events, hash_s: list) -> dict:
    """Per-step seconds of the trainer's host phases from its spans; the
    realize phase less the time ``step_digest`` took inside it."""
    out = {name: [] for name in STEP_PHASES}
    cur = dict.fromkeys(STEP_PHASES, 0.0)
    for e in events:
        if e["name"] in cur:
            cur[e["name"]] += e["dur"] / 1e6
        elif e["name"] == "train/step":
            for name in STEP_PHASES:
                out[name].append(cur[name])
            cur = dict.fromkeys(STEP_PHASES, 0.0)
    out["train/realize"] = [r - h for r, h in zip(out["train/realize"], hash_s)]
    return out


def train_run(grid: str, path: str = "stream+prefetch", profile_steps: int = 0) -> dict:
    """TRAIN_STEPS steps of the train launcher's trainer on ``--attn-grid
    grid`` and the data path ``DATA_PATHS[path]`` from seed-0 weights; the
    kernels' launches are counted from 0 just before the run and read just
    after it.  Each delivered step's host arrays are digested as the step
    leaves the data path, and the digests' time is taken out of the step
    times and the wall clock."""
    import math

    import torch

    from repro_torch import obs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tag = f"[train] grid={grid} path={path}"
    t_run = time.perf_counter()
    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(
        TRAIN_ARGS + ["--attn-grid", grid] + DATA_PATHS[path]))
    cfg = trainer.model.cfg
    t0 = time.perf_counter()
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"{tag}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f}M params {cfg.dtype}, "
          f"build {t0 - t_run:.1f}s, init {time.perf_counter() - t0:.1f}s")
    digests, hash_s = [], []

    def digested(epoch_fn):
        def steps(*args, **kwargs):
            inner = epoch_fn(*args, **kwargs)
            try:
                for loader_step in inner:
                    t = time.perf_counter()
                    digests.append(step_digest(loader_step, loader.layout))
                    hash_s.append(time.perf_counter() - t)
                    yield loader_step
            finally:
                inner.close()
        return steps

    # The loader's two public epoch iterators, wrapped on this instance for
    # the measured run only (the profile run below delivers undigested).
    loader.epoch = digested(loader.epoch)
    loader.streaming_epoch = digested(loader.streaming_epoch)
    reg, tracer = obs.default_registry(), obs.default_tracer()
    reg.reset()
    tracer.reset()
    tracer.enable()  # the trainer then syncs the card at the end of each step
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    state, steps = trainer.train_epoch(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - sum(hash_s)
    del loader.epoch, loader.streaming_epoch
    launches = dict(fa.LAUNCHES)
    tracer.disable()
    events = tracer.events()
    step_s = [e["dur"] / 1e6 - h for e, h in
              zip([e for e in events if e["name"] == "train/step"], hash_s)]
    phases = step_phases(events, hash_s)
    tokens = reg.flat()["train_tokens_total"]
    peak = torch.cuda.max_memory_allocated()
    check(steps == TRAIN_STEPS and len(trainer.history) == steps, f"{steps} steps run")
    check(len(digests) == steps, f"{tag}: {len(digests)} steps digested")
    for rec in trainer.history:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"step {rec['step']} on {tag}: loss {rec['loss']} grad_norm {rec['grad_norm']}")
        print(f"{tag} {Trainer.format_log_line(rec)}")
    n = cfg.n_layers * steps
    fwd, dq, dkv = (("segment_flash_attention_pruned", "segment_flash_attention_bwd_pruned_dq",
                     "segment_flash_attention_bwd_pruned_dkv") if grid == "pruned" else
                    ("segment_flash_attention", "segment_flash_attention_bwd_dq",
                     "segment_flash_attention_bwd_dkv"))
    want = {**dict.fromkeys(launches, 0), fwd: 2 * n, dq: n, dkv: n}
    check(launches == want, f"{tag}: launches {launches} != {want}")
    print(f"{tag}: launches {launches} ({steps} steps x {cfg.n_layers} layers; "
          f"remat runs the forward twice)")
    loss_tokens = [rec["tokens"] for rec in trainer.history]
    tokens_2_4 = sum(loss_tokens[1:]) / sum(step_s[1:])
    print(f"{tag}: tokens/s {tokens / wall:.1f} ({tokens:.0f} real tokens in {wall:.3f}s, the "
          f"data path's drain included), step s {[round(t, 4) for t in step_s]}, loss tokens/s "
          f"over steps 2..{steps} {tokens_2_4:.1f}, max_memory_allocated {peak / 2**30:.3f} GiB")
    print(f"{tag}: host phases per step (s): " + ", ".join(
        f"{name} {[round(x, 5) for x in phases[name]]}" for name in STEP_PHASES)
        + f"; step_digest {[round(x, 5) for x in hash_s]} (taken out of realize, step s and tokens/s)")
    prefetch = loader.last_prefetch_stats
    if prefetch is not None:
        print(f"{tag}: prefetch hits {prefetch.hits} misses {prefetch.misses} "
              f"wait_s {prefetch.wait_s:.5f} produce_s {prefetch.produce_s:.5f}")
    if loader.last_worker_stats is not None:
        print(f"{tag}: workers {loader.last_worker_stats.as_dict()}")
    if profile_steps:
        more = Trainer(trainer.model, loader, trainer.opt_cfg,
                       TrainerConfig(log_every=profile_steps, max_steps=profile_steps))

        def run():
            more.train_epoch(state)
            torch.cuda.synchronize()
            return profile_steps

        profile_run(run, "train", "step")
    print(f"{tag}: {time.perf_counter() - t_run:.1f}s in all")
    return dict(launches=launches, losses=[r["loss"] for r in trainer.history],
                grad_norms=[r["grad_norm"] for r in trainer.history], step_s=step_s,
                tokens_per_s=tokens / wall, tokens_per_s_2_4=tokens_2_4, peak_gib=peak / 2**30,
                digests=digests, phases=phases)


def phase_training() -> dict:
    """Full-width training on the default (pruned) route over three data
    paths, then on the dense route from the same weights and data; returns
    the kernels' launches, each from its own route's default-path run."""
    import torch

    runs = {}
    for i, path in enumerate(DATA_PATHS):
        runs[path] = train_run("pruned", path, profile_steps=2 if i == 0 else 0)
        torch.cuda.empty_cache()
    pruned = runs["stream+prefetch"]
    dense = train_run("dense")
    torch.cuda.empty_cache()
    for name, run in [*runs.items(), ("dense", dense)]:
        check(run["digests"] == pruned["digests"],
              f"{name}: step digests {run['digests']} != {pruned['digests']}")
        for i, (a, b) in enumerate(zip(run["losses"], pruned["losses"])):
            check(abs(a - b) <= LOSS_RTOL * abs(b),
                  f"step {i + 1}: loss {a} ({name}) vs {b} (pruned, stream+prefetch)")
    print(f"[train] every run's steps have the same host-array sha256 "
          f"({[d[:12] for d in pruned['digests']]}); per-step losses (rtol {LOSS_RTOL}): "
          + "; ".join(f"{name} {run['losses']}" for name, run in [*runs.items(), ("dense", dense)]))
    print(f"[train] loss tokens/s over steps 2..{TRAIN_STEPS}: "
          + ", ".join(f"{name} {run['tokens_per_s_2_4']:.1f}"
                      for name, run in [*runs.items(), ("dense", dense)]))
    launches = {name: dense["launches"][name] for name in KERNELS if KERNELS[name][2] == "dense"}
    launches.update({name: pruned["launches"][name] for name in KERNELS if KERNELS[name][2] == "pruned"})
    return launches


def visible_pairs(seg) -> int:
    """The (query, key) pairs that the causal segment mask lets through,
    summed over the batch rows: the work the attention function needs, which
    a live tile's masked entries (above the diagonal, across segments) add
    nothing to."""
    import torch

    pos = torch.arange(seg.shape[1], device=seg.device)
    causal = pos[None, :] <= pos[:, None]
    return sum(int((causal & (row[None, :] == row[:, None]) & (row[None, :] > 0)).sum())
               for row in seg)


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
        pairs = visible_pairs(seg) * HEADS
        flops = 4.0 * D_HEAD * pairs
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, k, v read, out written
        bound_s = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES else "bytes"
        kw = dict(block_q=blk, block_kv=blk)
        t_k1 = cuda_ms(lambda: fa.segment_flash_attention(q, k, v, seg, **kw))
        t_k4 = cuda_ms(lambda: fa.segment_flash_attention_pruned(q, k, v, seg, tables=tables, **kw))
        t_plain = cuda_ms(lambda: segment_flash_attention_ref(q, k, v, seg))
        qt, kt, vt, mask = sdpa_inputs(q, k, v, seg)
        t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        row = dict(rows=rows, cap=cap, block=blk, live_tiles=live, visible_pairs=pairs,
                   flops=flops, bytes=nbytes,
                   bound_ms=1e3 * bound_s, bound_by=bound_by, k1_ms=t_k1, k4_ms=t_k4,
                   plain_ms=t_plain, library_ms=t_lib)
        rows_out.append(row)
        for name, t in (("segment_flash_attention", t_k1), ("segment_flash_attention_pruned", t_k4)):
            print(f"[times] {name} rows={rows} cap={cap} bf16: kernel_ms {t:.4f} plain_ms "
                  f"{t_plain:.4f} library_ms {t_lib:.4f} bound_ms {1e3 * bound_s:.5f} ({bound_by}) "
                  f"live tiles {live} visible pairs {pairs} launches {launches[name]} "
                  f"(serving run, all shapes)")
    return rows_out


def phase_times_training(rng, train_seg) -> dict:
    """Every kernel at the first training step's shape (bf16): each pass of
    the backward alone through its C entry point, the plain version, the
    SDPA yardstick (its forward for K1/K4, its backward for the backward
    kernels) and the bound (4, 6 or 8 D FLOPs per visible (query, key) pair
    and head for the forward, dQ and dK/dV; each input read once, each output
    written once)."""
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
    pairs = visible_pairs(seg) * HEADS  # visible (row, q-head, query, key)
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
        "fwd": (4.0 * D_HEAD * pairs, 2 * qo_bytes + 2 * kv_bytes + stat_bytes + seg_bytes),
        "dq": (6.0 * D_HEAD * pairs, 3 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes),
        "dkv": (8.0 * D_HEAD * pairs, 2 * qo_bytes + 4 * kv_bytes + 2 * stat_bytes + seg_bytes),
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
              f"{r['bound_ms']:.5f} ({bound_by}) live tiles {live} visible pairs {pairs} "
              f"achieved {flops / ms / 1e9:.2f} TFLOP/s, bound share {r['bound_ms'] / ms:.4f}, "
              f"kernel/library {ms / r['library_ms']:.3f}")
    return dict(result, shape=[rows, cap, HEADS, KV_HEADS, D_HEAD], block=blk, live_tiles=live,
                visible_pairs=pairs)


def to_cpu(tree):
    """A detached CPU copy of a parameter tree (dicts, lists, tensors)."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.detach().cpu()


def ssd_case(rng, b, s, h, p, n, dtype, strided, decay=1.0):
    """x, adt, dt, B, C and an initial state on the card, drawn as the JAX
    sweep draws them.  With ``strided``, x, B and C are column views of one
    (B, S, H*P + 2N) tensor, as the model's conv output hands them over.
    ``decay`` scales a: at 1 the state forgets within ~20 steps, at 0.02 it
    carries over chunks, so the initial state reaches y and the final state."""
    import numpy as np
    import torch

    def card(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    xbc = card(np.concatenate([rng.standard_normal((b, s, h * p), dtype=np.float32) * 0.5,
                               rng.standard_normal((b, s, 2 * n), dtype=np.float32) * 0.4], axis=-1),
               dtype)
    x = xbc[..., : h * p].reshape(b, s, h, p)
    bp, cp = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    if not strided:
        x, bp, cp = x.contiguous(), bp.contiguous(), cp.contiguous()
    dt = card(np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32))))
    a = card(-np.exp(rng.standard_normal(h) * 0.3) * decay)
    init = card(rng.standard_normal((b, h, p, n), dtype=np.float32) * 0.5)
    return (x, (a[None, None, :] * dt).contiguous(), dt, bp, cp), init, a


def allowance_share(ours, ref, tol: dict) -> float:
    """The worst |ours - ref| as a share of what allclose allows there."""
    ours, ref = ours.float(), ref.float()
    return ((ours - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()


def phase_ssd(rng) -> float:
    """K7 against its plain chunked version (y and final state) and, once,
    against the sequential recurrence; returns the largest bf16 error."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_ref

    max_err, fp32_digest, fp32_cases = 0.0, hashlib.sha256(), 0
    cases = [(shape, dname, dtype, decay) for shape in SSD_SWEEP + (SSD_FULL,) for decay in (1.0, 0.02)
             for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16))]
    for shape, dname, dtype, decay in cases:
        b, s, h, p, n, chunk = shape
        args, init, _ = ssd_case(rng, b, s, h, p, n, dtype, strided=shape == SSD_FULL, decay=decay)
        for initial in (None, init):
            y, final = ssd.ssd_scan(*args, chunk=chunk, initial_state=initial, return_final_state=True)
            ry, rfinal = ssd_chunked_ref(*args, chunk, initial)
            torch.cuda.synchronize()
            err = (y.float() - ry.float()).abs().max().item()
            serr = (final - rfinal).abs().max().item()
            tol = SSD_TOL[dname]
            check(torch.allclose(y.float(), ry.float(), **tol) and torch.allclose(final, rfinal, **tol),
                  f"ssd_scan vs plain at {shape} {dname} init={initial is not None}: "
                  f"y err {err}, state err {serr}")
            if dname == "bfloat16":
                max_err = max(max_err, err)
            else:
                fp32_digest.update(y.cpu().numpy().tobytes())
                fp32_digest.update(final.cpu().numpy().tobytes())
                fp32_cases += 1
            print(f"[ssd] ssd_scan {shape} {dname} decay {decay} "
                  f"init={'random' if initial is not None else 'zero'}"
                  f"{' strided' if shape == SSD_FULL else ''}: max_abs_err y {err:.3g} "
                  f"(max |y| {ry.float().abs().max().item():.3g}; "
                  f"{allowance_share(y, ry, tol):.3f} of the allowance) state {serr:.3g} "
                  f"(max |state| {rfinal.abs().max().item():.3g}; "
                  f"{allowance_share(final, rfinal, tol):.3f}) "
                  f"(atol {tol['atol']}, rtol {tol['rtol']})")
    print(f"[ssd] fp32 route: sha256 of y and the final state over its {fp32_cases} cases "
          f"{fp32_digest.hexdigest()}")
    b, s, h, p, n, chunk = SSD_FULL
    (x, adt, dt, bp, cp), init, a = ssd_case(rng, b, s, h, p, n, torch.float32, strided=True, decay=0.02)
    y, final = ssd.ssd_scan(x, adt, dt, bp, cp, chunk=chunk, initial_state=init, return_final_state=True)
    ry, rfinal = ssd_scan_ref(x, dt, a, bp, cp, init)
    torch.cuda.synchronize()
    tol = SSD_TOL["float32"]
    err, serr = (y - ry).abs().max().item(), (final - rfinal).abs().max().item()
    check(torch.allclose(y, ry, **tol) and torch.allclose(final, rfinal, **tol),
          f"ssd_scan vs sequential recurrence at {SSD_FULL}: y err {err}, state err {serr}")
    print(f"[ssd] ssd_scan {SSD_FULL} float32 decay 0.02 init=random vs the sequential recurrence: "
          f"max_abs_err y {err:.3g} state {serr:.3g}")
    return max_err


def ssd_grad_case(rng, shape, dtype, mamba_init: bool):
    """The SSD's inputs on the card as the model hands them over: ``xbc``,
    one (B, S, H*P + 2N) tensor that x, B and C are column views of, and dt,
    a fp32, and a cotangent weight w.  With ``mamba_init``, dt =
    softplus(N(0, 0.25)) (dt_bias 0) and a over [-1, -16], as mamba2's init
    draws them; else the JAX sweep's draws."""
    import numpy as np
    import torch

    b, s, h, p, n, _ = shape
    xbc = torch.from_numpy(np.concatenate(
        [rng.standard_normal((b, s, h * p), dtype=np.float32) * 0.5,
         rng.standard_normal((b, s, 2 * n), dtype=np.float32) * 0.4], axis=-1)).to("cuda", dtype)
    if mamba_init:
        dt = torch.nn.functional.softplus(torch.from_numpy(
            rng.standard_normal((b, s, h), dtype=np.float32) * 0.5)).cuda()
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))).cuda()
        a = -torch.from_numpy(np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32)).cuda()
    return xbc, dt, a, w


def split_xbc(xbc, h: int, p: int, n: int):
    """x (B, S, H, P), B and C (B, S, N): views of ``xbc``, as the model slices them."""
    b, s, _ = xbc.shape
    return xbc[..., : h * p].reshape(b, s, h, p), xbc[..., h * p : h * p + n], xbc[..., h * p + n :]


def phase_ssd_grad(rng) -> float:
    """The SSD's autograd Function (K7 forward, the plain chunked form's
    gradient backward) against plain autograd through the plain version;
    returns the largest bf16 gradient error."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    worst = 0.0
    for shape in SSD_SWEEP + (SSD_FULL,):
        b, s, h, p, n, chunk = shape
        full = shape == SSD_FULL
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            xbc, dt, a, w = ssd_grad_case(rng, shape, dtype, mamba_init=full)
            out = {}
            for route in ("function", "plain"):
                leaves = [t.detach().clone().requires_grad_() for t in (xbc, dt, a)]
                x, bp, cp = split_xbc(leaves[0], h, p, n)
                ssd.reset_launches()
                if route == "function":
                    y = ops.ssd_chunked_scan(x, leaves[1], leaves[2], bp, cp, chunk=chunk)
                    check(ssd.LAUNCHES["ssd_scan"] == 1,
                          f"the SSD Function launched K7 {ssd.LAUNCHES['ssd_scan']} times at {shape}")
                else:
                    y, _ = ssd_chunked_ref(x, leaves[2][None, None, :] * leaves[1], leaves[1], bp, cp, chunk)
                out[route] = (y, torch.autograd.grad((y.float() * w).sum(), leaves))
            torch.cuda.synchronize()
            (y, grads), (ry, rgrads) = out["function"], out["plain"]
            check(torch.allclose(y.float(), ry.float(), **SSD_TOL[dname]),
                  f"SSD Function y vs plain at {shape} {dname}")
            tol = dict(atol=TOL[dname], rtol=TOL[dname])
            parts = []
            for name, g, ref in zip(("x|B|C", "dt", "a"), grads, rgrads):
                check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(ref).all()),
                      f"SSD gradient of {name} not finite at {shape} {dname}")
                err = (g.float() - ref.float()).abs().max().item()
                check(torch.allclose(g.float(), ref.float(), **tol),
                      f"SSD Function gradient of {name} vs plain autograd at {shape} {dname}: err {err}")
                if dname == "bfloat16":
                    worst = max(worst, err)
                parts.append(f"{name} {err:.3g} (max |g| {ref.float().abs().max().item():.3g}; "
                             f"{allowance_share(g, ref, tol):.3f} of the allowance)")
            print(f"[ssd_grad] {shape} {dname} strided{', mamba2 init' if full else ''}: y err "
                  f"{(y.float() - ry.float()).abs().max().item():.3g}; gradients vs plain autograd "
                  f"(atol = rtol = {TOL[dname]}), all finite: " + ", ".join(parts))
            del out, y, ry, grads, rgrads
    torch.cuda.empty_cache()
    return worst


def phase_ssm() -> int:
    """Full-width mamba2-130m: per-request prefill and greedy decode in bf16,
    then the fp32 rail.  Returns K7's launches in the prefill call."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import LM

    cfg = get_config("mamba2_130m")
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[ssm] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} d_inner {cfg.d_inner} "
          f"{cfg.n_ssm_heads} heads x {cfg.ssm_headdim}, d_state {cfg.d_state}, chunk {cfg.ssm_chunk}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(SSM_ROWS, SSM_PROMPT))).cuda()
    max_len = SSM_PROMPT + SSM_DECODE

    def generate(prompt):
        logits, caches = model.prefill(params, prompt, max_len)
        tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
        out = [tok]
        for i in range(SSM_DECODE):
            logits, caches = model.decode_step(params, caches, tok, prompt.shape[1] + i)
            tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
            out.append(tok)
        return logits, torch.cat(out, dim=1)

    generate(tokens[:, :256])  # warm-up: cuBLAS handles, the kernel library, allocator pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd.reset_launches()
    t = time.perf_counter()
    logits, caches = model.prefill(params, tokens, max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = ssd.LAUNCHES["ssd_scan"]
    check(prefill_launches == cfg.n_layers, f"K7 launched {prefill_launches} times in one prefill, "
                                            f"not {cfg.n_layers}")
    check(bool(torch.isfinite(logits).all()) and logits.shape == (SSM_ROWS, 1, logits.shape[-1]),
          f"prefill logits {tuple(logits.shape)} not finite")
    ssd.reset_launches()
    tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
    t = time.perf_counter()
    for i in range(SSM_DECODE):
        logits, caches = model.decode_step(params, caches, tok, SSM_PROMPT + i)
        tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    check(ssd.LAUNCHES["ssd_scan"] == 0, f"K7 launched {ssd.LAUNCHES['ssd_scan']} times during decode")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] prefill {SSM_ROWS} x {SSM_PROMPT}: {1e3 * prefill_s:.2f} ms "
          f"({SSM_ROWS * SSM_PROMPT / prefill_s:.0f} prompt tokens/s), K7 launches {prefill_launches}; "
          f"decode {SSM_DECODE} steps: {1e3 * decode_s / SSM_DECODE:.3f} ms per step, "
          f"{SSM_ROWS * SSM_DECODE / decode_s:.1f} generated tokens/s (decode), "
          f"{SSM_ROWS * (SSM_DECODE + 1) / (prefill_s + decode_s):.1f} generated tokens/s (prefill + decode), "
          f"K7 launches in decode 0; max_memory_allocated {peak / 2**30:.3f} GiB")

    def run():
        generate(tokens)
        torch.cuda.synchronize()
        return 1 + SSM_DECODE

    profile_run(run, "ssm", "call")  # one prefill and SSM_DECODE decode steps
    del logits, caches, model, params
    torch.cuda.empty_cache()

    # The fp32 rail at 2 x 512: teacher-forced decode against the full
    # forward on the card (both through K7), and the card's prefill against
    # the CPU port's on the same weights.
    import dataclasses

    rows, length, split = SSM_RAIL
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = LM(cfg32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(rows, length))).cuda()
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks})
    first, caches = model.prefill(params, toks[:, :split], length)
    steps = [first]
    for i in range(split, length - 1):
        lg, caches = model.decode_step(params, caches, toks[:, i : i + 1], i)
        steps.append(lg)
    # The forward's padded vocabulary columns carry a -1e9 bias; decode's do not.
    dec = torch.cat(steps, dim=1)[..., : cfg.vocab_size]
    ref = full[:, split - 1 : length - 1, : cfg.vocab_size]
    err = (dec - ref).abs().max().item()
    check(torch.allclose(dec, ref, atol=2e-3, rtol=2e-3),
          f"fp32 teacher-forced decode vs full forward: max_abs_err {err}")
    print(f"[ssm] fp32 {rows} x {length}: prefill {split} + {length - 1 - split} teacher-forced decode "
          f"steps vs the full forward: max_abs_err {err:.3g} (atol = rtol = 2e-3)")
    card_first, _ = model.prefill(params, toks, length)
    cpu_model = LM(cfg32, device="cpu")
    cpu_params = cpu_model.load_params(to_cpu(params))
    cpu_first, _ = cpu_model.prefill(cpu_params, toks.cpu(), length)
    err = (card_first.cpu() - cpu_first).abs().max().item()
    check(torch.allclose(card_first.cpu(), cpu_first, atol=1e-3, rtol=1e-3),
          f"fp32 prefill logits card vs CPU port: max_abs_err {err}")
    print(f"[ssm] fp32 {rows} x {length} prefill logits, card (K7) vs CPU port (plain): "
          f"max_abs_err {err:.3g} (atol = rtol = 1e-3)")
    del full, dec, ref, model, params
    torch.cuda.empty_cache()
    return prefill_launches


@contextlib.contextmanager
def step_phases_wrapped(model, wrap):
    """Within the block, ``wrap(name, fn)`` wraps the train step's forward
    (``LM.loss_sums`` on ``model``), its optimizer (the trainer's
    ``adamw_update``) and every SSD backward (``_SsdScan.backward``)."""
    from repro_torch.kernels import ops
    from repro_torch.train import trainer as trainer_mod

    update, backward = trainer_mod.adamw_update, ops._SsdScan.backward
    model.loss_sums = wrap("forward", model.loss_sums)  # shadows the method on this instance
    trainer_mod.adamw_update = wrap("optimizer", update)
    ops._SsdScan.backward = staticmethod(wrap("ssd backward", backward))
    try:
        yield
    finally:
        del model.loss_sums
        trainer_mod.adamw_update = update
        ops._SsdScan.backward = backward


def event_spans(marks, steps: int) -> dict:
    """Device ms per step from (name, start, stop) CUDA events: forward,
    optimizer and SSD backward as recorded; the backward from the forward's
    end to the optimizer's start (remat's recompute included); the step from
    the forward's start to the optimizer's end."""
    spans = dict.fromkeys(("forward", "backward", "optimizer", "ssd backward", "step"), 0.0)
    forward = None
    for name, start, stop in marks:
        spans[name] += start.elapsed_time(stop)
        if name == "forward":
            forward = (start, stop)
        elif name == "optimizer":
            spans["backward"] += forward[1].elapsed_time(start)
            spans["step"] += forward[0].elapsed_time(stop)
    return {name: ms / steps for name, ms in spans.items()}


def kernel_ms_by_range(events) -> dict:
    """Device kernel ms by the innermost ``record_function`` range named
    RANGE_PREFIX... around the host op that launched the kernel (on the
    op's thread); "rest" for kernels launched outside every such range."""
    import torch

    ops, ranges = {}, {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        if e.name().startswith(RANGE_PREFIX):
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), e.name()[len(RANGE_PREFIX):]))
        elif e.linked_correlation_id() == 0:  # a host op (kernels and launches link to one)
            ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    out: dict = {}
    for e in events:
        if not is_kernel(e):
            continue
        name, op = "rest", ops.get(e.linked_correlation_id())
        if op is not None:
            inside = [r for r in ranges.get(op[0], ()) if r[0] <= op[1] <= r[1]]
            if inside:
                name = max(inside)[2]  # the latest start: the innermost range
        out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6
    return out


def phase_ssm_train() -> dict:
    """Full-width mamba2-130m training through the train launcher; returns
    K7's launches in the measured run and what the kernels line reports."""
    import math

    import torch

    from repro_torch import obs
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tag = "[ssm_train]"
    t_run = time.perf_counter()
    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(SSM_TRAIN_ARGS))
    cfg = trainer.model.cfg
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f}M params {cfg.dtype}, "
          f"remat {cfg.remat}; {' '.join(SSM_TRAIN_ARGS)}")
    reg, tracer = obs.default_registry(), obs.default_tracer()
    reg.reset()
    tracer.reset()
    tracer.enable()  # the trainer then syncs the card at the end of each step
    torch.cuda.reset_peak_memory_stats()
    ssd.reset_launches()
    t0 = time.perf_counter()
    state, steps = trainer.train_epoch(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ssd.LAUNCHES["ssd_scan"]
    tracer.disable()
    step_s = [e["dur"] / 1e6 for e in tracer.events() if e["name"] == "train/step"]
    peak = torch.cuda.max_memory_allocated()
    check(steps == SSM_TRAIN_STEPS and len(trainer.history) == steps, f"{tag} {steps} steps run")
    for rec in trainer.history:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{tag} step {rec['step']}: loss {rec['loss']} grad_norm {rec['grad_norm']}")
        print(f"{tag} {Trainer.format_log_line(rec)}")
    want = 2 * cfg.n_layers * steps
    check(launches == want, f"{tag} K7 launched {launches} times in {steps} steps, not {want}")
    tokens = [rec["tokens"] for rec in trainer.history]
    tokens_2_4 = sum(tokens[1:]) / sum(step_s[1:])
    print(f"{tag} K7 launches {launches} ({steps} steps x {cfg.n_layers} layers x 2: remat runs the "
          f"forward twice); tokens/s {reg.flat()['train_tokens_total'] / wall:.1f} over all {steps} "
          f"steps, {tokens_2_4:.1f} over steps 2..{steps}; step s {[round(t, 4) for t in step_s]}; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")

    def two_more():
        Trainer(trainer.model, loader, trainer.opt_cfg,
                TrainerConfig(log_every=2, max_steps=2)).train_epoch(state)
        torch.cuda.synchronize()
        return 2

    # Two more steps with CUDA events around the phases: their device spans.
    marks = []

    def event_timed(name, fn):
        def call(*args, **kwargs):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            marks.append((name, start, stop))
            return out
        return call

    with step_phases_wrapped(trainer.model, event_timed):
        two_more()
    split = event_spans(marks, 2)
    print(f"{tag} device spans per step over 2 more steps (CUDA events): forward {split['forward']:.1f} ms, "
          f"backward {split['backward']:.1f} (remat's recompute included), optimizer "
          f"{split['optimizer']:.1f}, step {split['step']:.1f}; the SSD backward (the plain chunked "
          f"form's gradient, {cfg.n_layers} calls) {split['ssd backward']:.1f} ms, "
          f"{split['ssd backward'] / split['step']:.3f} of the step")

    # Two more under the profiler, the same phases as ranges: kernel time.
    def annotated(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(RANGE_PREFIX + name):
                return fn(*args, **kwargs)
        return call

    with step_phases_wrapped(trainer.model, annotated):
        profiled = profile_run(two_more, "ssm_train", "step")
    k7_ms, kernel_split = None, {}
    if profiled is not None:
        by_name, events = profiled
        k7_ms = sum(ms for name, ms in by_name.items() if "ssd" in name) / 2
        kernel_split = {name: ms / 2 for name, ms in kernel_ms_by_range(events).items()}
        total = sum(kernel_split.values())
        print(f"{tag} device kernel ms per step by phase (profiled): " + ", ".join(
            f"{name} {ms:.1f} ({ms / total:.3f})" for name, ms in sorted(kernel_split.items()))
            + f"; rest = the backward outside the SSD's (remat's recompute included) and glue; "
              f"K7's kernels {k7_ms:.2f} ms")
    print(f"{tag} {time.perf_counter() - t_run:.1f}s in all")
    del state, trainer
    torch.cuda.empty_cache()
    return dict(launches=launches, launches_per_step=launches // steps, tokens_per_s_2_4=tokens_2_4,
                step_s=step_s, peak_gib=peak / 2**30, k7_ms_per_step=k7_ms,
                kernel_ms_per_step=kernel_split,
                **{f"{name.replace(' ', '_')}_ms_per_step": ms for name, ms in split.items()})


def phase_resume() -> None:
    """Checkpoints of full-width mamba2 training: a save every two steps, a
    restore into a fresh trainer, two more steps; then the launcher's
    restart loop on the smoke config up to its first checkpoint."""
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as train_launcher
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import tree_leaves

    (ROOT / "build").mkdir(exist_ok=True)
    directory = pathlib.Path(tempfile.mkdtemp(prefix="resume-", dir=ROOT / "build"))
    save, restore = ckpt.save_checkpoint, ckpt.restore_checkpoint
    seconds = {"save": [], "restore": []}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t)
            return out
        return call

    def trainer_for(steps: int):
        argv = [*SSM_TRAIN_ARGS, "--checkpoint-dir", str(directory)]
        argv[argv.index("--steps") + 1] = str(steps)
        trainer, _ = train_launcher.build(train_launcher.parser().parse_args(argv))
        trainer.cfg = dataclasses.replace(trainer.cfg, checkpoint_every=2, keep_checkpoints=2)
        return trainer

    ckpt.save_checkpoint, ckpt.restore_checkpoint = timed("save", save), timed("restore", restore)
    try:
        first = trainer_for(4)
        state, step = first.restore_or_init(torch.Generator(device="cuda").manual_seed(0))
        check(step == 0, f"[resume] a fresh directory restored step {step}")
        state, step = first.train_epoch(state, start_step=step)
        files = sorted(p.name for p in directory.glob("step_*.npz"))
        check(step == 4 and ckpt.latest_step(directory) == 4
              and files == ["step_00000002.npz", "step_00000004.npz"],
              f"[resume] after {step} steps: latest {ckpt.latest_step(directory)}, files {files}")
        nbytes = (directory / "step_00000004.npz").stat().st_size
        fresh = trainer_for(6)
        restored, step = fresh.restore_or_init(torch.Generator(device="cuda").manual_seed(1))
        check(step == 4, f"[resume] restored step {step}, not 4")
        pairs = list(zip(tree_leaves(restored), tree_leaves(state)))
        check(len(pairs) == len(tree_leaves(state)) and all(
            a.device == b.device and a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs),
            "[resume] the restored state differs from the saved one")
        del state, first
        restored, step = fresh.train_epoch(restored, start_step=step)
        losses = [rec["loss"] for rec in fresh.history]
        check(step == 6 and len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"[resume] two more steps after the restore: step {step}, losses {losses}")
        print(f"[resume] full width: checkpoints at steps 2 and 4 (keep 2), {nbytes} bytes each; save s "
              f"{[round(t, 3) for t in seconds['save']]}, restore s "
              f"{[round(t, 3) for t in seconds['restore']]}; step 4 restored with each of {len(pairs)} "
              f"leaves torch.equal to the saved state; steps 5-6 losses {losses}")
        del restored, fresh
        torch.cuda.empty_cache()
        shutil.rmtree(directory)
        directory.mkdir()
        args = train_launcher.parser().parse_args(
            [*RESUME_LAUNCHER_ARGS, "--steps", "20", "--checkpoint-dir", str(directory)])
        trainer, _ = train_launcher.build(args)
        _, step = train_launcher.run(trainer, args)
        check(step == 20 and ckpt.latest_step(directory) == 20,
              f"[resume] launcher: step {step}, latest {ckpt.latest_step(directory)}")
        like = trainer.init_state(torch.Generator(device="cuda").manual_seed(2))
        check(ckpt.restore_checkpoint(directory, like, cfg=trainer.model.cfg, step=20) == 20,
              "[resume] the launcher's step_00000020.npz is not readable")
        print(f"[resume] launcher --checkpoint-dir on the smoke config, 20 steps: latest.json step 20, "
              f"step_00000020.npz readable ({(directory / 'step_00000020.npz').stat().st_size} bytes)")
    finally:
        ckpt.save_checkpoint, ckpt.restore_checkpoint = save, restore
        shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()


# -- dp_train: Eq. 2 data-parallel training over torch.distributed ------------


def dp_rank_main(rank: int, world: int, init_file: str, queue, want_digests: list) -> None:
    """One rank of the dp_train phase's gloo run, spawned: both ranks share
    the card.  Per step: this rank's rows of the loader's step, a digest of
    the step gathered through ``ResilientCollective(TorchProcessCollective)``
    under a deadline, ``dp_step``, and rank 0 holding its parameters
    ``torch.equal`` to rank 1's (broadcast over the group).  Runs the
    uncompressed and then the compressed step from the same weights and puts
    what it saw on ``queue``."""
    import datetime

    import torch
    import torch.distributed as dist

    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        try:
            for compress in (False, True):
                out["compressed" if compress else "exact"] = dp_run(rank, world, want_digests,
                                                                      compress)
        finally:
            dist.destroy_process_group()
    except BaseException as exc:  # reported to the parent, which fails the phase
        import traceback

        out["error"] = f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"
    queue.put(out)


def dp_run(rank: int, world: int, want_digests: list, compress: bool) -> dict:
    """DP_STEPS steps of ``dp_step`` on full-width Qwen3-0.6B from seed-0
    weights over the default process group; K1-K3 counted from 0 just before
    the steps and read just after.  With more than one rank, rank 0 checks
    its parameters ``torch.equal`` to rank 1's after every step."""
    import math

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.comm import ResilientCollective, TorchProcessCollective
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.optimizer import init_opt_state, tree_leaves
    from repro_torch.train.trainer import assemble_model_batch, dp_step

    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(DP_ARGS))
    model = trainer.model
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    state = {"params": params, "opt": init_opt_state(params, trainer.opt_cfg)}
    step, init_error_state = dp_step(model, trainer.opt_cfg, compress_grads=compress)
    err = init_error_state(params)
    collective = ResilientCollective(TorchProcessCollective(world), deadline_s=120.0)
    flat = other = None
    rec = {"loss": [], "grad_norm": [], "step_s": [], "equal": [], "digests": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    for i, loader_step in enumerate(loader.epoch(0)):
        if i == DP_STEPS:
            break
        digest = step_digest(loader_step, loader.layout)
        words = np.frombuffer(bytes.fromhex(digest)[:32], dtype=np.int64)
        gathered = collective.all_gather(rank, words)
        check(all(np.array_equal(g, words) for g in gathered),
              f"[dp_train] rank {rank} step {i + 1}: the ranks' step digests differ")
        check(digest == want_digests[i],
              f"[dp_train] rank {rank} step {i + 1}: digest {digest} != the single process's")
        t = time.perf_counter()
        batch = assemble_model_batch(loader_step, loader.layout, model.device)
        b = batch["tokens"].shape[0]
        check(b % world == 0, f"[dp_train] {b} rows do not split over {world} ranks")
        rows = slice(rank * b // world, (rank + 1) * b // world)
        batch = {k: batch[k][rows] for k in ("tokens", "labels", "loss_mask")}
        state, metrics, err = step(state, batch, err)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t)
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"[dp_train] rank {rank} step {i + 1}: loss {loss} grad_norm {gnorm}")
        rec["loss"].append(loss)
        rec["grad_norm"].append(gnorm)
        rec["digests"].append(digest)
        if world > 1:
            with torch.no_grad():
                flat = torch.cat([p.detach().reshape(-1) for p in tree_leaves(state["params"])])
                if rank == 0:
                    other = torch.empty_like(flat) if other is None else other
                    dist.broadcast(other, src=1)
                    rec["equal"].append(bool(torch.equal(flat, other)))
                else:
                    dist.broadcast(flat, src=1)
            del flat
    rec["launches"] = dict(fa.LAUNCHES)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["rows"] = [rows.start, rows.stop]
    rec["layers"] = model.cfg.n_layers
    return rec


def dp_launches_ok(rec: dict, tag: str) -> None:
    n = rec["layers"] * len(rec["loss"])
    want = {**dict.fromkeys(rec["launches"], 0), "segment_flash_attention": 2 * n,
            "segment_flash_attention_bwd_dq": n, "segment_flash_attention_bwd_dkv": n}
    check(rec["launches"] == want, f"{tag}: launches {rec['launches']} != {want}")


def phase_dp_train() -> dict:
    """Full-width Qwen3-0.6B, dense layout at --world 2 --l-max 4096, the
    flash route (K1 forward, K2/K3 backward): the single-process ``Trainer``
    as the reference, then ``dp_step`` at world 1 over NCCL in this process,
    then at world 2 over gloo in two spawned ranks sharing the card (exact,
    then bf16-compressed gradients).  Returns the world-2 run's K1-K3
    launches per rank."""
    import math
    import tempfile
    from queue import Empty

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch import obs
    from repro_torch.launch import train as train_launcher

    tag = "[dp_train]"
    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(DP_ARGS))
    state = trainer.init_state(torch.Generator(device=trainer.model.device).manual_seed(0))
    digests = []
    epoch = loader.epoch

    def digested(*args, **kwargs):
        for loader_step in epoch(*args, **kwargs):
            digests.append(step_digest(loader_step, loader.layout))
            yield loader_step

    loader.epoch = digested
    trainer.cfg = dataclasses.replace(trainer.cfg, streaming=False)
    tracer = obs.default_tracer()
    tracer.reset()
    tracer.enable()  # the trainer then syncs the card at the end of each step
    torch.cuda.reset_peak_memory_stats()
    state, steps = trainer.train_epoch(state)
    tracer.disable()
    ref = {"loss": [r["loss"] for r in trainer.history],
           "grad_norm": [r["grad_norm"] for r in trainer.history],
           "step_s": [e["dur"] / 1e6 for e in tracer.events() if e["name"] == "train/step"]}
    check(steps == DP_STEPS and len(ref["loss"]) == DP_STEPS, f"{tag} reference ran {steps} steps")
    print(f"{tag} single-process Trainer ({' '.join(DP_ARGS)}): losses {ref['loss']}, grad_norm "
          f"{ref['grad_norm']}, step s {[round(x, 4) for x in ref['step_s']]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, digests "
          f"{[d[:12] for d in digests]}")
    del state, trainer, loader
    torch.cuda.empty_cache()

    def held(rec, name):
        for key in ("loss", "grad_norm"):
            for i, (a, b) in enumerate(zip(rec[key], ref[key])):
                check(abs(a - b) <= DP_RTOL * abs(b),
                      f"{tag} {name} step {i + 1}: {key} {a} vs the single process's {b}")

    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="dp-", dir=ROOT / "build"))
    try:
        dist.init_process_group("nccl", init_method=f"file://{work / 'nccl'}", rank=0, world_size=1)
        try:
            nccl = dp_run(0, 1, digests, compress=False)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        held(nccl, "world 1 over NCCL")
        dp_launches_ok(nccl, f"{tag} world 1 over NCCL")
        print(f"{tag} world 1 over NCCL: losses {nccl['loss']}, grad_norm {nccl['grad_norm']}, step s "
              f"{[round(s, 4) for s in nccl['step_s']]}, peak {nccl['peak_gib']:.3f} GiB, launches "
              f"{nccl['launches']}")

        ctx = tmp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=dp_rank_main, args=(r, 2, str(work / "gloo"), queue, digests))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            results = []
            while len(results) < len(procs):
                try:
                    results.append(queue.get(timeout=5))
                except Empty:
                    check(all(p.is_alive() for p in procs),
                          f"{tag} a rank exited without a result: exit codes "
                          f"{[p.exitcode for p in procs]}")
            results.sort(key=lambda r: r["rank"])
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
        for r in results:
            check("error" not in r, f"{tag} rank {r['rank']} failed: {r.get('error')}")
        for r in results:
            exact, comp = r["exact"], r["compressed"]
            name = f"world 2 over gloo, rank {r['rank']} (rows {exact['rows']})"
            held(exact, name)
            dp_launches_ok(exact, f"{tag} {name}")
            dp_launches_ok(comp, f"{tag} {name}, compressed")
            for i, (a, b) in enumerate(zip(comp["loss"], exact["loss"])):
                check(math.isfinite(a) and abs(a - b) <= DP_RTOL * abs(b),
                      f"{tag} {name} compressed step {i + 1}: loss {a} vs {b}")
            for i, (a, b) in enumerate(zip(comp["grad_norm"], exact["grad_norm"])):
                check(math.isfinite(a) and abs(a - b) <= DP_COMP_RTOL * abs(b),
                      f"{tag} {name} compressed step {i + 1}: grad_norm {a} vs {b}")
            print(f"{tag} {name}: losses {exact['loss']}, grad_norm {exact['grad_norm']}, step s "
                  f"{[round(s, 4) for s in exact['step_s']]}, peak {exact['peak_gib']:.3f} GiB, "
                  f"launches {exact['launches']}; compressed: losses {comp['loss']}, grad_norm "
                  f"{comp['grad_norm']}, step s {[round(s, 4) for s in comp['step_s']]}, peak "
                  f"{comp['peak_gib']:.3f} GiB")
        equal = results[0]["exact"]["equal"] + results[0]["compressed"]["equal"]
        check(len(equal) == 2 * DP_STEPS and all(equal),
              f"{tag} rank 0's parameters torch.equal to rank 1's after each step: {equal}")
        print(f"{tag} world 2: the ranks' parameters torch.equal after every step "
              f"({len(equal)} checks); losses and grad_norm within {DP_RTOL} of the single process, "
              f"the compressed run's grad_norm within {DP_COMP_RTOL} of the exact run's")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    return results[0]["exact"]["launches"]


# -- probes: the measured block probe, an --attn-autotune run, --layout auto ---------


def scraped_steps(body: str) -> float:
    """``train_steps_total`` in a Prometheus text body (0 when absent)."""
    for line in body.splitlines():
        if line.startswith("train_steps_total "):
            return float(line.split()[1])
    return 0.0


def phase_probes(train_seg) -> dict:
    """The block probe at the first training step's shape on both grids and
    at the packed run's (2, 4096) on the pruned grid, each then serving a
    second call from the cache; the train launcher with --attn-autotune
    and telemetry for three steps (one GET /metrics during the run); the
    train launcher's --layout auto calibration.  Returns the autotune run's
    K4-K6 launches (the probe's included)."""
    import math
    import shutil
    import tempfile
    import threading
    import urllib.request

    import torch

    from repro_torch import obs
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher

    tag = "[probes]"
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="probes-", dir=ROOT / "build"))
    default_cache = autotune.DEFAULT_CACHE_PATH
    autotune.DEFAULT_CACHE_PATH = work / "attn_blocks_cuda.json"
    reg = obs.default_registry()
    real_scrape, real_run = obs.start_scrape_server, train_launcher.run
    try:
        step1 = tuple(train_seg.shape)
        picks = {}
        for (rows, cap), grid in ((step1, "dense"), (step1, "pruned"), ((2, 4096), "pruned")):
            cell = (rows, cap, HEADS, KV_HEADS, D_HEAD)
            reg.reset()
            t = time.perf_counter()
            pick = autotune.autotune_blocks(*cell, dtype=torch.bfloat16, has_segments=True,
                                            grid=grid)
            probe_s = time.perf_counter() - t
            windows = autotune.LAST_PROBE["windows"]
            check(reg.flat().get("kernel_autotune_cache_misses_total") == 1
                  and set(windows) == set(autotune.candidate_blocks(cap)),
                  f"{tag} the probe at {cell} grid {grid} did not run every candidate")
            again = autotune.autotune_blocks(*cell, dtype=torch.bfloat16, has_segments=True,
                                             grid=grid)
            check(again == pick and reg.flat().get("kernel_autotune_cache_hits_total") == 1
                  and reg.flat().get("kernel_autotune_cache_misses_total") == 1,
                  f"{tag} the second call at {cell} grid {grid} was not served from the cache")
            picks[autotune.LAST_PROBE["key"]] = pick
            print(f"{tag} block probe {autotune.LAST_PROBE['key']}: ms per forward+backward, "
                  f"median of {autotune.WINDOWS} windows of "
                  f"{autotune.CALLS_PER_WINDOW} calls [fastest-slowest window] "
                  + ", ".join(f"{bq}x{bk} {1e3 * autotune.LAST_PROBE['seconds'][(bq, bk)]:.4f} "
                              f"[{1e3 * min(ts):.4f}-{1e3 * max(ts):.4f}]"
                              for (bq, bk), ts in sorted(windows.items()))
                  + f"; pick {pick} (heuristic {autotune.heuristic_blocks(cap)}); probe "
                  f"{probe_s:.3f}s; second call served from the cache")

        tel = work / "telemetry"
        seen, done, captured = [], threading.Event(), {}

        def poll(url):
            while not done.is_set():
                with urllib.request.urlopen(url, timeout=10) as resp:
                    seen.append((resp.status, resp.read().decode()))
                if scraped_steps(seen[-1][1]) >= 1:
                    return
                done.wait(0.2)

        def scrape(port, *args, **kwargs):
            srv = real_scrape(port, *args, **kwargs)
            captured["poller"] = threading.Thread(target=poll, args=(srv.url,), daemon=True)
            captured["poller"].start()
            return srv

        def run(trainer, args):
            captured["trainer"] = trainer
            return real_run(trainer, args)

        obs.start_scrape_server, train_launcher.run = scrape, run
        autotune.DEFAULT_CACHE_PATH = work / "run_blocks_cuda.json"  # the run probes its own shapes
        reg.reset()
        fa.reset_launches()
        t = time.perf_counter()
        train_launcher.main(PROBE_TRAIN_ARGS + ["--telemetry", str(tel), "--telemetry-port", "0"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = dict(fa.LAUNCHES)
        done.set()
        captured["poller"].join(30)
        history = captured["trainer"].history
        check(len(history) == PROBE_STEPS and all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in history),
            f"{tag} --attn-autotune run: {history}")
        files = sorted(p.name for p in tel.iterdir())
        check({"metrics.json", "trace.json", "rounds.json"} <= set(files), f"{tag} telemetry {files}")
        check(any(status == 200 and scraped_steps(body) >= 1 for status, body in seen),
              f"{tag} no GET /metrics during the run returned 200 with train_steps_total >= 1")
        flat = reg.flat()
        probe_spans = [round(e["dur"] / 1e6, 3) for e in obs.default_tracer().events()
                       if e["name"] == "kernels/autotune"]
        print(f"{tag} --attn-autotune run ({' '.join(PROBE_TRAIN_ARGS)}): losses "
              f"{[r['loss'] for r in history]}, {run_s:.1f}s with its probes ({probe_spans} s; misses "
              f"{flat.get('kernel_autotune_cache_misses_total')}, hits "
              f"{flat.get('kernel_autotune_cache_hits_total')}), schedule "
              f"{autotune.cached_schedule()}, launches {launches}; telemetry {files}; "
              f"{len(seen)} GET /metrics during the run, the last {seen[-1][0]} with "
              f"{seen[-1][1].count(chr(10))} lines")
        obs.default_tracer().disable()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        args = train_launcher.parser().parse_args(LAYOUT_AUTO_ARGS)
        _, loader = train_launcher.build(args)
        print(f"{tag} --layout auto --calibration-steps {args.calibration_steps}: chose "
              f"{loader.layout.name} in {time.perf_counter() - t:.1f}s")
    finally:
        obs.start_scrape_server, train_launcher.run = real_scrape, real_run
        autotune.DEFAULT_CACHE_PATH = default_cache
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=launches, picks=picks)


def ssd_work(b, s, h=24, p=64, n=128, chunk=256, elem=2):
    """(FLOPs, bytes) of the least work of one K7 call with the final state:
    C.B^T once per (b, chunk) and, per (b, h, chunk), W.x over the causal
    pairs j <= i, C.state and the state update; x, adt, dt, B, C read once,
    y and the fp32 final state written once."""
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * (b * nc * pairs * n + b * h * nc * (pairs * p + 2 * chunk * p * n))
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * n) + 4 * (2 * b * s * h + b * h * p * n)
    return flops, nbytes


def ssd_device_launches(call, calls: int = 10) -> tuple:
    """The device launches behind K7 calls under ``torch.profiler``, after
    two warm-up calls under the same profiler that it does not record: the
    kernel launches per call, counted on the host (``cudaLaunchKernel``,
    which the profiler records every time), and by kernel name (launches
    recorded on the device per call, mean ms per launch).  The device side
    can miss a whole call's events now and then, so it names the kernels
    and times them but does not count them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    warmup = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=calls, repeat=1)) as prof:
        for _ in range(warmup + calls):
            call()
            torch.cuda.synchronize()
            prof.step()
    host_launches, by_name = 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith("ProfilerStep"):  # the step's own annotation
                n, ms = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        elif e.name.startswith("cudaLaunchKernel"):
            host_launches += 1
    return host_launches / calls, {name: (n / calls, ms / n) for name, (n, ms) in by_name.items()}


def phase_times_ssd(rng) -> list:
    """K7 and its plain version at the [ssm] prefill's shape (8, 2048), at
    one long sequence and at the first SSM training step's (2, 6144), as the
    model calls it (strided views, no initial state, final state out): y and
    the final state held against each other at the bf16 tolerance, the
    device launches of one call counted under the profiler, then each
    timed."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    rows = []
    for b, s in SSD_TIMES:
        args, _, _ = ssd_case(rng, b, s, 24, 64, 128, torch.bfloat16, strided=True)
        y, final = ssd.ssd_scan(*args, chunk=256, return_final_state=True)
        ry, rfinal = ssd_chunked_ref(*args, 256)
        torch.cuda.synchronize()
        tol = SSD_TOL["bfloat16"]
        err = (y.float() - ry.float()).abs().max().item()
        serr = (final - rfinal).abs().max().item()
        check(torch.allclose(y.float(), ry.float(), **tol) and torch.allclose(final, rfinal, **tol),
              f"ssd_scan vs plain at ({b}, {s}) bf16 strided: y err {err}, state err {serr}")
        print(f"[ssd] ssd_scan ({b}, {s}, 24, 64, 128, 256) bfloat16 decay 1.0 init=zero strided: "
              f"max_abs_err y {err:.3g} (max |y| {ry.float().abs().max().item():.3g}; "
              f"{allowance_share(y, ry, tol):.3f} of the allowance) state {serr:.3g} "
              f"(max |state| {rfinal.abs().max().item():.3g}; {allowance_share(final, rfinal, tol):.3f}) "
              f"(atol {tol['atol']}, rtol {tol['rtol']})")
        del y, final, ry, rfinal
        call = lambda: ssd.ssd_scan(*args, chunk=256, return_final_state=True)  # noqa: E731
        per_call, kernels = ssd_device_launches(call)
        check(per_call == SSD_BF16_KERNELS and len(kernels) == SSD_BF16_KERNELS,
              f"a bf16 K7 call must launch {SSD_BF16_KERNELS} device kernels: the profiler "
              f"counted {per_call} launches per call, of the kernels {sorted(kernels)}")
        for kname, (n, ms) in kernels.items():
            print(f"[times] ssd_scan B={b} S={s}: device kernel {kname.split('(')[0]} "
                  f"{ms:.4f} ms per launch ({n:g} launches recorded on the device per call; profiled)")
        # The wrapper's scratch: the peak allocated during one call, less
        # what the call returns.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y, final = call()
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated() - base - y.untyped_storage().nbytes()
                   - final.untyped_storage().nbytes())
        del y, final
        t_k = cuda_ms(call, iters=5, warmup=1)
        t_plain = cuda_ms(lambda: ssd_chunked_ref(*args, 256), iters=3, warmup=1)
        flops, nbytes = ssd_work(b, s)
        bound_by = "operations" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES else "bytes"
        bound_ms = 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
        rows.append(dict(shape=[b, s, 24, 64, 128, 256], ms=t_k, plain_ms=t_plain, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes, max_abs_err=err,
                         device_launches=per_call))
        print(f"[times] ssd_scan B={b} S={s} H=24 P=64 N=128 chunk=256 bf16: kernel_ms {t_k:.4f} "
              f"plain_ms {t_plain:.4f} library_ms none (no PyTorch call computes the SSD) bound_ms "
              f"{bound_ms:.5f} ({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
              f"achieved {flops / t_k / 1e9:.2f} TFLOP/s, {nbytes / t_k / 1e9:.3f} TB/s, bound share "
              f"{bound_ms / t_k:.4f}; device launches per call {per_call:g}; scratch "
              f"{scratch} bytes (peak allocated during one call less y and the final state: "
              f"chunk states, decays, scores; not in the bound)")
        del args
    torch.cuda.empty_cache()
    return rows


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

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f"[phase] {phase.__name__} {time.perf_counter() - t:.1f}s")
        return out

    name, count = timed(phase_device)
    timed(phase_build)
    train_seg = training_segments()
    max_err = timed(phase_parity, np.random.default_rng(0), train_seg)
    max_err.update(timed(phase_backward, np.random.default_rng(2), train_seg))
    ssd_err = timed(phase_ssd, np.random.default_rng(4))
    ssd_grad_err = timed(phase_ssd_grad, np.random.default_rng(7))
    serve_launches = timed(phase_serving)
    train_launches = timed(phase_training)
    ssm_launches = timed(phase_ssm)
    ssm_train = timed(phase_ssm_train)
    timed(phase_resume)
    dp_launches = timed(phase_dp_train)
    probes = timed(phase_probes, train_seg)
    serve_times = timed(phase_times, np.random.default_rng(1), serve_launches)[-1]  # (8, 256)
    times = timed(phase_times_training, np.random.default_rng(3), train_seg)
    ssd_times = timed(phase_times_ssd, np.random.default_rng(6))
    kernels = []
    for kname, (source, replaces, grid, _) in KERNELS.items():
        t = times[kname]
        entry = dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=train_launches[kname], max_abs_err=max_err[kname],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=times["shape"], dtype="bfloat16",
            launches_note=f"{TRAIN_STEPS} training steps on attn_grid={grid}, the train "
                          "launcher's default data path (streaming with prefetch)",
        )
        if grid == "dense":
            entry.update(launches_dp_train=dp_launches[kname],
                         launches_dp_train_note=f"per rank, {DP_STEPS} dp_step steps at world 2 "
                                                "over gloo (dense layout, flash route)")
        else:
            entry.update(launches_autotune_run=probes["launches"][kname],
                         launches_autotune_run_note=f"{PROBE_STEPS} training steps with "
                                                    "--attn-autotune, its block probes included")
        if kname in serve_launches:
            entry.update(
                launches_serving=serve_launches[kname],
                serving_ms=serve_times["k1_ms" if grid == "dense" else "k4_ms"],
                serving_plain_ms=serve_times["plain_ms"], serving_library_ms=serve_times["library_ms"],
                serving_bound_ms=serve_times["bound_ms"],
                serving_shape=[serve_times["rows"], serve_times["cap"], HEADS, KV_HEADS, D_HEAD],
            )
        kernels.append(entry)
    main_shape, long_shape, train_shape = ssd_times
    kernels.append(dict(
        name="ssd_scan", route="cuda", source=SSD, replaces=SSD_REPLACES,
        launches=ssm_train["launches"], max_abs_err=max(ssd_err, main_shape["max_abs_err"]),
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"], library_ms=None,
        shape=main_shape["shape"], dtype="bfloat16",
        launches_note=f"{SSM_TRAIN_STEPS} training steps of mamba2-130m ({' '.join(SSM_TRAIN_ARGS[:8])}): "
                      f"{ssm_train['launches_per_step']} per step, the forward of the SSD's autograd "
                      f"Function (remat runs it twice); one LM.prefill of {SSM_ROWS} x {SSM_PROMPT} "
                      f"launches launches_prefill, {SSM_DECODE} decode steps none",
        launches_prefill=ssm_launches,
        training_route=dict(
            forward="K7 (kernels/ops.py _SsdScan.forward)",
            backward="autograd of the plain chunked form (kernels/ref.py ssd_chunked_ref); no TPU kernel",
            launches_per_step=ssm_train["launches_per_step"], grad_max_abs_err=ssd_grad_err,
            shape=train_shape["shape"], ms=train_shape["ms"], plain_ms=train_shape["plain_ms"],
            bound_ms=train_shape["bound_ms"], bound_by=train_shape["bound_by"],
            max_abs_err=train_shape["max_abs_err"], k7_ms_per_step=ssm_train["k7_ms_per_step"],
            ssd_backward_span_ms_per_step=ssm_train["ssd_backward_ms_per_step"],
            step_span_ms=ssm_train["step_ms_per_step"],
            kernel_ms_per_step=ssm_train["kernel_ms_per_step"]),
        long_shape=long_shape["shape"], long_ms=long_shape["ms"], long_plain_ms=long_shape["plain_ms"],
        long_bound_ms=long_shape["bound_ms"], long_bound_by=long_shape["bound_by"],
        device_launches_per_call=main_shape["device_launches"],
    ))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
