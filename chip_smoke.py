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
               d_head 64 at 3 x 96, and the added architectures' layouts:
               16 over 16 at d_head 80 bidirectional, a group of 7 (56 over
               8; 14 over 2 at d_head 80 bidirectional), a group of 1 (32
               over 32)), in fp32 (the CUDA-core route) and bf16
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
               64 (3 x 96, block 96) and at the added architectures' layouts
               (as in parity), in bf16 and fp32: each against the
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
               per step, K4-K6 never, with the same digests and losses; in
               every run the AdamW kernels launched 4 + 1 + 4 times a step, in
               ``kernels/adamw.LAUNCHES`` and in the registry's
               ``kernel_adamw_launches_total``; per run tokens/s (and over
               steps 2..4, which leave out the first step's warm-up and the
               data path's drain after the last),
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
13. chaos    — (a) ``repro_torch.chaos.run_all`` at seeds 0 and 1, every
               rail held (terminated, within the round bound, ok; the drop
               aborted; bit-exact but for poison_sample, which is accounted);
               (b) the training run's cell with the JAX harness's buffer 4
               and prefetch 4, four steps taken as the trainer takes them
               (``streaming_epoch(prefetch=True, device_put=True,
               fault_injector=...)`` -> ``assemble_model_batch`` -> the
               trainer's step) from seed-0 weights: fault-free twice, then
               under a transient ``gather_delay`` (every step's
               ``stream_digest``, host-array sha256, loss and grad_norm equal
               to the fault-free run's: bitwise when the pair is bitwise,
               else within its spread), a ``gather_drop`` that aborts with
               steps staged on the card and resumes from the abort's
               checkpoint (the same standard, no step lost or taken twice),
               and poison samples under a quarantine budget (the epoch
               ends, fully accounted, the plan's identities quarantined,
               finite losses); each run's rounds, wall and recovery cost;
               (c) every comparator's schedule (Standard, Sorted, Packing,
               GMT, BMT, HFG, ODB) for the run's data at world 2, the
               benchmark's sizes cut to one card, and one full-width step
               on Standard's first step (dense, K1-K3) and GMT's (packed,
               K4-K6); (d) the tile census of the first training step
               against the liveness tables built on the card;
14. archs    — the six architectures added after Qwen3 and mamba2, at full
               width, random weights from seed 0, bf16, the kernels' counts
               set to 0 before each run and read after it: OLMo-1B
               (non-parametric LN, 16 over 16 heads) trains ARCH_TRAIN_STEPS
               steps through the train launcher (``--layout packed --world 2
               --l-max 4096``; K4 2 x 16, K5 and K6 16 per step), then one
               step's loss and gradients on the pruned and the dense grid
               must be bitwise equal; HuBERT-XLarge (encoder: bidirectional,
               d_head 80, LN, GELU, input embeddings) takes one ``loss_sums``
               with its gradients on a packed embeds batch of 2 x 4096 frames
               (K4 2 x 48, K5 and K6 48) and one encode, its loss on the
               dense grid bitwise equal to the pruned grid's; DeepSeek-7B
               (32 over 32 heads) serves the serving phase's trace whole
               through ``python -m repro_torch.launch.serve --arch
               deepseek_7b`` (its defaults), and
               Yi-34B (56 over 8) and Chameleon-34B (64 over 8, qk-norm) at 4
               layers and Arctic-480B (MoE, 128 experts of 7168 x 4864 top-2,
               a dense residual MLP) at 1 layer serve the same 24-request
               trace through the engine (K4 n_layers times per prefill call,
               K1 never); per run tokens/s, step or tick time, peak memory,
               for HuBERT the loss, grad norm and encode time, for Arctic the
               (token, expert) pairs dropped at capacity in the first prefill
               and over the run; finite losses; after each run K1-K6 (K1 and
               K4 for the served models) held against their plain versions
               in both dtypes at the segment ids the run gave its attention
               (OLMo's step 1, HuBERT's batch, each prefill bucket's first
               call; DeepSeek's buckets with seeded packing) and the model's
               heads, K4 == K1, K5 == K2, K6 == K3 bitwise;
15. mla_hybrid — DeepSeek-V3 (MLA, the 3-layer dense prefix, 256 experts
               top-8 with a shared one) cut to 4 layers and Jamba-1.5-Large
               (the hybrid period) cut to 2 (``attn_period=2``: a Mamba-2
               layer with the 16-expert MoE, an attention layer with the
               dense MLP), full width, bf16, random weights from seed 0,
               one after the other: ``LM.prefill`` of 8 prompts of 1024
               (DeepSeek-V3) or 2048 (Jamba) tokens and 32 greedy
               ``decode_step``s (prefill ms, decode ms a step, tokens/s,
               peak memory, the MoE's dropped pairs in the prefill; Jamba's
               prefill launches K4 and K7 once each, decode nothing;
               DeepSeek-V3's serving launches no kernel: MLA with a cache and
               the MoE are plain, as in JAX); the mixer rails (layer 0's mixer, and Jamba's
               attention layer, on their real inputs: the prefill of the
               run's prompts and 4 cached one-token steps against one
               cache-free call, within 2e-2 of the output's scale, which
               holds the absorbed MLA decode against the direct form and
               the SSM state and conv tail and the KV cache across the
               prefill); the whole-model rail (a 4-token prompt and 4
               ``decode_step``s against ``LM.forward``, logits within 2e-2
               of their scale, no pair dropped); one ``loss_sums`` with its
               gradients under ``remat="full"`` on 1 (DeepSeek-V3) or 2
               (Jamba) packed rows of 4096 in 256-2048-token segments
               (loss, grad norm, ms, peak; DeepSeek-V3 the MLA kernels, 2
               forwards, a dQ and a dK/dV pass a layer; Jamba K4 2, K5 1, K6 1, K7 2, and
               its loss and every gradient on the dense grid bitwise equal
               to the pruned grid's); then K1-K6 held at Jamba's loss
               segments and prefill rows with its 64/8 heads, both dtypes
               (fp32 at the loss's segments against float64, at
               JAMBA_LOSS_EXACT_TOL), and K7 held and timed at Jamba's
               prefill (8, 2048, 256, 64, 128) and held at its loss's
               (2, 4096);
16. mesh      — (a) ``launch/flash_dryrun.validate_flash_sharded`` at
               Qwen3-0.6B's 16/8 heads, d_head 128, on the first training
               step's 2 x 6144 rows, bf16 and fp32, both grids: at world 1
               over NCCL in this process and at world 2 over gloo in two
               spawned ranks sharing the card (one row each, the pruned
               grid's liveness tables built from the rank's own segments):
               each rank's out, dQ, dK, dV bitwise equal to the single-process
               call's rows (else the worst error, held at the kernel's
               tolerance), one launch of each of the grid's kernels per call
               and rank, ms per rank; (b) full-width Qwen3-0.6B packed
               training (the training phase's cell, the pruned route),
               MESH_TRAIN_STEPS steps from seed-0 weights under remat "full",
               "dots" and "none" on the same batches: "dots"'s loss and
               grad_norm bitwise "full"'s, "none" within MESH_REMAT_RTOL, K4
               2 x 28 a step under "full" and "dots" and 28 under "none"; peak
               memory and step ms per mode; (c) ``python -m
               repro_torch.launch.dryrun --mesh both`` for each of MESH_CELLS
               in subprocesses on the card's torch (the fake process group,
               the meta device): bytes per device and their parts, fits,
               the dominant roofline term;
17. ep        — expert parallelism on full-width Arctic-480B cut to one layer
               (128 experts of 7168 x 4864, top-2, the dense residual),
               bf16, weights from seed 0 made once in this process: the
               engine serving the default trace's first 8 requests (K4 once
               a prefill call) and one ``loss_sums`` with its gradients on a
               packed row of 4096 (K4 2, K5 1, K6 1), at world 1 over NCCL
               (the single-device branch), then at world 2 over gloo in two
               spawned ranks sharing the card and the weights (CUDA IPC; 64
               experts and half the dense residual a rank),
               ``dispatch_chunks`` 1 and then 2; per rank the peak, tick and
               loss ms and the launches; at one chunk the pairs kept and
               dropped, summed over the ranks, equal world 1's, and the first
               prefill's logits, the loss and every gradient (held shard by
               shard against world 1's on the host) lie within the bf16
               allowance (2e-2 x (1 + |ref|)), each printed as a share of it;
               K1-K6 held at the loss's segments and K1/K4 at the prefill
               buckets with Arctic's 56/8 heads; then
               ``examples/serve_packed_torch.py``, ``quickstart_torch.py``,
               ``train_100m_torch.py --preset 100m --steps 6`` and
               ``odb_vs_standard_torch.py`` run on the card side by side
               (their tails printed);
18. times     — K1, K4 at the serving shapes and K2, K3, K5, K6 at the first
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
               and the final state); K1-K6 also at the added architectures'
               head layouts on two packed rows of 4096 (HuBERT-XLarge's 16
               over 16 at d_head 80, bidirectional; Yi-34B's and Arctic-480B's
               56 over 8, causal); at each of these shapes the timed inputs
               are first held against the plain version (K1-K6, bf16);
19. adamw    — the multi-tensor AdamW (``kernels/adamw.py``, no TPU
               kernel) at full-width Qwen3-0.6B's 311 leaves (bf16 weights
               and gradients, fp32 moments, a clipped step): held against the
               plain version given the kernel's norm (bit for bit) and the
               plain norm (relative 1e-6), then timed beside its bound (24 B
               a weight once), the plain version and, as a yardstick the port
               never calls, ``clip_grad_norm_(foreach=True)`` with
               ``torch.optim.AdamW(fused=True)`` over the same leaves;
20. mla      — the MLA kernels (``kernels/mla_attention.py``, no TPU kernel:
               the JAX package computes MLA with XLA einsums) at the
               DeepSeek-V2-Lite cell's shape (MLA_SHAPE: 8 packed rows of
               3072 slots of UltraChat-like samples, 16 heads, qk 192 over v
               128, bf16): held against the plain version (out and the
               gradients at 2e-2 of 1 + |plain|, lse at 2e-5), then the
               forward and the backward timed beside their bounds (2 (qk +
               v), 2 (2 qk + v) and 4 (qk + v) FLOPs per visible pair and
               head; every tensor moved once), each kernel's device time
               under ``torch.profiler``, the liveness tables' build, the plain
               version, the model's plain blockwise path, and, as a yardstick
               the port never calls, SDPA with the same boolean mask;
21. kernels  — one JSON line with every ported kernel, the AdamW kernel and
               the MLA kernels.

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
import math
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
# The multi-tensor AdamW, which replaces no TPU kernel.
ADAMW = "src/repro_torch/kernels/csrc/adamw.cu"
ADAMW_REPLACES = ("none: src/repro/train/optimizer.py is plain jnp, which XLA fuses under jit; "
                  "eager PyTorch launches each op as a kernel")
# its launches in one step of Qwen3-0.6B's 311 leaves (four groups of at most 80)
ADAMW_STEP_LAUNCHES = {"adamw_sqnorm": 4, "adamw_finish": 1, "adamw_update": 4}
# The MLA kernels, which replace no TPU kernel, at the DeepSeek-V2-Lite cell's
# shape: rows, slots a row, heads.
MLA = "src/repro_torch/kernels/csrc/mla_attention.cu"
MLA_REPLACES = ("none: src/repro/models/attention.py mla_attention is XLA einsums; the port's plain "
                "path was fp32 blockwise einsums over whole rows")
MLA_SHAPE = (8, 3072, 16)
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
# The chaos phase.  (a) runs the harness matrix at these seeds.  (b) trains
# the training run's cell under faults; the launcher's --buffer 256
# --prefetch 64 admit the whole epoch in two gather rounds, so (b) takes the
# JAX harness's buffer 4 and prefetch 4 (a gather every three or four steps)
# for a round to land among the trained steps.
CHAOS_SEEDS = (0, 1)
CHAOS_TRAIN_ARGS = [*TRAIN_ARGS, "--buffer", "4", "--prefetch", "4"]
CHAOS_DEADLINE_S = 0.05  # the harness's round deadline; injected delays are simulated
CHAOS_MAX_DELAY_S = 1.0  # gather_delay at rate 1: 95 % of (round, rank) sites miss the deadline
CHAOS_POISON = 3
# (c): benchmarks/throughput.py's SELECTED[("ultrachat", "2b")], and the cut
# to one card at full width: each value lowered until the schedule's largest
# step lays out in at most CELL_SLOTS token slots (the training run's largest
# step, 2 x 6144), on the layout the method trains with (dense for the
# fixed batch sizes, packed for the token budgets and ODB); lmax is the cell's.
COMPARATOR_SELECTED = dict(std_bs=8, sorted_bs=16, lmax=16384, budget=16384, hfg_bs=8)
COMPARATOR_CUT = dict(std_bs=1, sorted_bs=1, lmax=4096, budget=6144, hfg_bs=1)
CELL_SLOTS = 2 * 6144
# The archs phase: the six architectures added after Qwen3 and mamba2, at
# full width.  OLMo-1B trains through the train launcher; HuBERT-XLarge
# (encoder-only, input embeddings) takes one loss and its gradients on a
# packed embeds batch and one encode; DeepSeek-7B is served whole through
# the serve launcher's defaults, and the three that do not fit one card
# serve the same whole trace through the engine with their depth cut
# (arch -> layers).
ARCH_TRAIN_STEPS = 4
ARCH_TRAIN_ARGS = ["--arch", "olmo_1b", "--layout", "packed", "--world", "2", "--l-max", "4096",
                   "--steps", str(ARCH_TRAIN_STEPS), "--log-every", "1"]
HUBERT_ROWS, HUBERT_FRAMES = 2, 4096
ARCH_SERVE_CUT = {"yi_34b": 4, "chameleon_34b": 4, "arctic_480b": 1}
ARCH_SERVE_REQUESTS = 24  # the serve launcher's default trace
# The mla_hybrid phase: DeepSeek-V3 and Jamba at full width with their depth
# cut to fit one card (arch -> (ArchConfig overrides, serving prompt length,
# packed training rows of MLA_HYBRID_LEN)); 8 prompts, 32 decode steps, and
# the cache rails' 4 one-token steps.
MLA_HYBRID = {
    "deepseek_v3_671b": (dict(n_layers=4), 1024, 1),  # the 3 dense layers + 1 MoE layer of 256 experts
    "jamba_1_5_large": (dict(n_layers=2, attn_period=2), 2048, 2),  # a Mamba-2 + MoE layer, an attention layer
}
MLA_HYBRID_ROWS, MLA_HYBRID_DECODE, MLA_HYBRID_LEN, RAIL_STEPS = 8, 32, 4096, 4
# The fp32 flash kernels at Jamba's loss (a GQA group of 8, segments up to
# ~3500 tokens) are held against float64 within this atol = rtol instead of
# against the plain fp32 version within 2e-5: there dK and dV sum ~28,000
# fp32 terms, and two correct fp32 orders of that sum differ by more than
# 2e-5.  The H100 readings (PERF.md): the kernels 0.629 (dK) and 0.716 (dV)
# of 2e-5·(1 + |exact|) from fp64 and the plain version 0.551 and 0.716 on
# one draw; on another the plain version 0.980, the kernels 4.24e-5 from it.
# So twice the fp32 tolerance.  Every other case keeps the plain rule.
JAMBA_LOSS_EXACT_TOL = 4e-5
MLA_HYBRID_NOTE = ("per run of the mla_hybrid phase: each model's serving (LM.prefill of 8 prompts and 32 "
                   "decode steps) and one loss with its gradients on the pruned grid (remat runs the "
                   "forward twice); DeepSeek-V3's loss runs the MLA kernels (kernels/mla_attention: 2 "
                   "forwards, a dQ and a dK/dV pass a layer), its serving and its MoE are plain, as in JAX")
# The flash kernels' times at the added architectures' head layouts, each on
# two packed rows of 4096 (label, widths).
ARCH_TIME_SHAPES = (
    ("HuBERT-XLarge", dict(heads=16, kv_heads=16, d_head=80, causal=False)),
    ("Yi-34B / Arctic-480B", dict(heads=56, kv_heads=8, d_head=128, causal=True)),
)


# The mesh phase: remat's training steps, the tolerance of remat="none"
# against "full" (bf16 weights; the kernels are the same, the roundings of
# the saved and recomputed activations are not), the dry run's cells.
MESH_TRAIN_STEPS = 2
MESH_REMAT_RTOL = 2e-2
MESH_CELLS = ("qwen3_0_6b:train_4k_packed", "deepseek_v3_671b:train_4k", "jamba_1_5_large:long_500k")
# The ep phase: full-width Arctic-480B cut to one layer (128 experts of 7168 x
# 4864 and the dense residual), the serving trace's first requests and one
# packed row for the loss, at world 1 (NCCL) and 2 (gloo, 64 experts a rank).
EP_ARCH, EP_LAYERS = "arctic_480b", 1
EP_REQUESTS = 8
EP_LEN = 4096
EP_WORLD = 2
EP_CHUNKS = (1, 2)
EP_NOTE = (f"per run of the ep phase (full-width Arctic-480B cut to {EP_LAYERS} layer): the engine serving "
           f"the default trace's first {EP_REQUESTS} requests, and one loss_sums with its gradients on 1 x "
           f"{EP_LEN} packed tokens; world 1 over NCCL, and per rank at world {EP_WORLD} over gloo "
           f"(expert parallelism, dispatch_chunks {' and '.join(map(str, EP_CHUNKS))})")
EP_EXAMPLES = (("examples/serve_packed_torch.py",), ("examples/quickstart_torch.py",),
               ("examples/train_100m_torch.py", "--preset", "100m", "--steps", "6"),
               ("examples/odb_vs_standard_torch.py",))  # schedules and the paper's cost model: no model


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


def long_segments(rng, rows: int, cap: int, lo: int = 256, hi: int = 2048):
    """Seeded packing of long samples (documents, utterances) of lo..hi
    tokens back to back with a padding tail, and their within-segment
    positions."""
    import numpy as np

    seg = np.zeros((rows, cap), np.int32)
    pos = np.zeros((rows, cap), np.int32)
    for r in range(rows):
        end = cap - int(rng.integers(1, cap // 16))
        cursor, seg_id = 0, 1
        while cursor < end:
            n = min(int(rng.integers(lo, hi + 1)), end - cursor)
            seg[r, cursor:cursor + n] = seg_id
            pos[r, cursor:cursor + n] = np.arange(n)
            cursor, seg_id = cursor + n, seg_id + 1
    return seg, pos


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


def flash_cases(rng, train_seg) -> list:
    """(label, segment ids, options) of the parity cases: the serving
    shapes, the first training step's, block 40 at 3 x 200, a peaked
    softmax (q x 4: P near one-hot, large dS terms cancelling in dK, bf16
    rounding at its worst), a GQA group of 8 (16 q heads over 2), d_head 64
    at 3 x 96 (block 96), and the added architectures' head layouts and
    masks: HuBERT-XLarge's 16 over 16 heads at d_head 80, bidirectional;
    Yi-34B's and Arctic-480B's GQA group of 7 (56 over 8); a group of 7 at
    d_head 80, bidirectional; DeepSeek-7B's group of 1 (32 over 32)."""
    return [
        *((f"serving {rows}x{cap}", packed_segments(rng, rows, cap), {}) for rows, cap in SHAPES),
        ("training step", train_seg, {}), ("block 40", packed_segments(rng, 3, 200), {}),
        ("peaked q x4", packed_segments(rng, 2, 1024), dict(q_scale=4.0)),
        ("group 8", packed_segments(rng, 2, 512), dict(kv_heads=2)),
        ("d_head 64", packed_segments(rng, 3, 96), dict(d_head=64)),
        ("d_head 80 non-causal", packed_segments(rng, 2, 512),
         dict(heads=16, kv_heads=16, d_head=80, causal=False)),
        ("group 7", packed_segments(rng, 2, 512), dict(heads=56, kv_heads=8)),
        ("group 7 d_head 80 non-causal", packed_segments(rng, 2, 256),
         dict(heads=14, kv_heads=2, d_head=80, causal=False)),
        ("group 1", packed_segments(rng, 2, 512), dict(heads=32, kv_heads=32)),
    ]


def phase_parity(rng, train_seg):
    """K1 and K4 against the plain forward at every flash case in both
    dtypes (compare_kernels), and the liveness tables on the card against
    the CPU's; returns the bf16 errors."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables

    max_err = {"segment_flash_attention": 0.0, "segment_flash_attention_pruned": 0.0}
    for label, seg_np, extra in flash_cases(rng, train_seg):
        errs = hold_kernels(rng, f"[parity] {label}", seg_np, backward=False, **extra)
        max_err = {name: max(err, errs[name]) for name, err in max_err.items()}
        seg, blk = torch.from_numpy(seg_np).cuda(), fa.select_block(seg_np.shape[1], 128)
        causal = extra.get("causal", True)
        on_card = build_liveness_tables(seg, block_q=blk, block_kv=blk, causal=causal)
        on_cpu = build_liveness_tables(seg.cpu(), block_q=blk, block_kv=blk, causal=causal)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
              f"liveness tables differ between card and CPU at {label}")
        print(f"[parity] liveness tables card == cpu {label} {tuple(seg.shape)} "
              f"live tiles {int(on_card.kv_count.sum())}/{seg.shape[0] * (seg.shape[1] // blk) ** 2}")
    return max_err


def training_segments():
    """The segment ids of the training run's first step, from the train
    launcher's data path (no model weights are made)."""
    from repro_torch.core.layout import global_batch_arrays
    from repro_torch.launch import train as train_launcher

    _, loader = train_launcher.build(train_launcher.parser().parse_args(TRAIN_ARGS))
    first = next(iter(loader.epoch(0)))
    return global_batch_arrays(first.batches, loader.layout)["segments"]


def bwd_case(rng, seg, dtype, q_scale=1.0, causal=True, **widths):
    """Inputs of one backward call: q (times ``q_scale``), k, v, seg, and the
    forward's out and lse (from K1 under the ``causal`` mask), and a
    cotangent do; ``widths`` override make_case's heads, kv_heads and d_head."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    q, k, v, seg_t = make_case(rng, seg, dtype, **widths)
    q = (q.float() * q_scale).to(dtype)
    blk = fa.select_block(seg.shape[1], 128)
    out, lse = fa.segment_flash_attention(q, k, v, seg_t, block_q=blk, block_kv=blk, return_lse=True,
                                          causal=causal)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to("cuda", dtype)
    return (q, k, v, seg_t, out, lse, do), blk


def exact_attention(q, k, v, seg, causal: bool, backward=None):
    """The segment-masked attention in float64, one kv head's group at a
    time: (out, lse) of q, k, v and, with ``backward`` = (out, lse, do) as
    the backward kernels take them, also (dq, dk, dv) of those inputs: the
    reference of ``compare_kernels(exact_tol=...)``."""
    import torch

    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / d**0.5
    pos = torch.arange(s, device=q.device)
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    if causal:
        allowed &= pos[None, None, :] <= pos[None, :, None]
    out, dq = (torch.zeros(q.shape, dtype=torch.float64, device=q.device) for _ in range(2))
    dk, dv = (torch.zeros(k.shape, dtype=torch.float64, device=q.device) for _ in range(2))
    lse = torch.zeros((b, s, h), dtype=torch.float64, device=q.device)
    for kh in range(kv):
        sl = slice(kh * g, (kh + 1) * g)
        qd, kd, vd = q[:, :, sl].double(), k[:, :, kh].double(), v[:, :, kh].double()
        scores = torch.einsum("bqgd,bsd->bgqs", qd, kd).mul_(scale).masked_fill_(~allowed[:, None], -torch.inf)
        lse_h = torch.logsumexp(scores, -1, keepdim=True)
        p = torch.exp(scores - lse_h).nan_to_num_(0.0)  # rows with no visible key: zero
        out[:, :, sl] = torch.einsum("bgqs,bsd->bqgd", p, vd)
        lse[:, :, sl] = lse_h[..., 0].permute(0, 2, 1)
        if backward is not None:
            o_in, lse_in, do = backward
            p = torch.exp(scores - lse_in[:, :, sl].double().permute(0, 2, 1)[..., None]).nan_to_num_(0.0)
            dod = do[:, :, sl].double()
            ds = torch.einsum("bqgd,bsd->bgqs", dod, vd)
            ds.sub_((dod * o_in[:, :, sl].double()).sum(-1).permute(0, 2, 1)[..., None]).mul_(p)
            dq[:, :, sl] = torch.einsum("bgqs,bsd->bqgd", ds, kd) * scale
            dk[:, :, kh] = torch.einsum("bgqs,bqgd->bsd", ds, qd) * scale
            dv[:, :, kh] = torch.einsum("bgqs,bqgd->bsd", p, dod)
            del ds
        del scores, p
    return (out, lse) if backward is None else (out, lse, dq, dk, dv)


def compare_kernels(args, blk: int, causal: bool, dname: str, where: str, backward: bool = True,
                    exact_tol: float | None = None) -> dict:
    """K1 and K4 (and, with ``backward``, K2/K3 and K5/K6) on the inputs
    ``args`` = (q, k, v, seg, out, lse, do), out and lse from K1: each against
    its plain version on valid rows (out and the gradients at the dtype's
    tolerance, lse at 2e-5), K4 == K1, K5 == K2 and K6 == K3 bit for bit, and
    exactly zero on all-padding rows.  Returns each kernel's max abs error.

    With ``exact_tol`` (fp32 only), out and the gradients are held instead
    against their float64 value (``exact_attention``) within
    exact_tol·(1 + |exact|), and the plain fp32 version's share of that
    allowance is printed beside the kernels'.  JAMBA_LOSS_EXACT_TOL says
    where and why."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import segment_flash_attention_bwd_ref, segment_flash_attention_ref

    check(exact_tol is None or dname == "float32", f"exact_tol is for fp32 only, not {dname}")
    q, k, v, seg, o1, l1, do = args
    kw = dict(block_q=blk, block_kv=blk, causal=causal)
    o4, l4 = fa.segment_flash_attention_pruned(q, k, v, seg, return_lse=True, **kw)
    ro, rl = segment_flash_attention_ref(q, k, v, seg, causal=causal, return_lse=True)
    got = {"segment_flash_attention": [(o1, ro)]}
    pairs = [("segment_flash_attention", "segment_flash_attention_pruned", (o1, l1), (o4, l4))]
    if backward:
        dense = fa.segment_flash_attention_bwd(q, k, v, seg, o1, l1, do, **kw)
        pruned = fa.segment_flash_attention_bwd_pruned(q, k, v, seg, o1, l1, do, **kw)
        plain = segment_flash_attention_bwd_ref(q, k, v, seg, o1, l1, do, causal=causal)
        (dq_name, _), (dkv_name, _) = BWD_PAIRS
        got.update({dq_name: [(dense[0], plain[0])], dkv_name: [(dense[1], plain[1]), (dense[2], plain[2])]})
        pairs += [(*BWD_PAIRS[0], dense[:1], pruned[:1]), (*BWD_PAIRS[1], dense[1:], pruned[1:])]
    torch.cuda.synchronize()
    shape = f"{tuple(seg.shape)} heads {q.shape[2]}/{k.shape[2]} d_head {q.shape[3]} causal {causal}"
    for dense_name, pruned_name, a, b in pairs:
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{pruned_name} not bit-exact vs {dense_name} at {where} {shape} {dname}")
    valid, tol = seg > 0, TOL[dname]
    lerr = (l1[valid] - rl[valid]).abs().max().item()
    check(torch.allclose(l1[valid], rl[valid], atol=TOL["float32"], rtol=TOL["float32"]),
          f"segment_flash_attention lse vs plain at {where} {shape} {dname}: err {lerr}")
    against, note = "plain", ""
    if exact_tol is not None:
        # (kernel, plain) pairs become (kernel, fp64), with the plain fp32
        # outputs kept to print their own distance from fp64
        exact = exact_attention(q, k, v, seg, causal, (o1, l1, do) if backward else None)
        exact = [exact[0], *exact[2:]]
        plains = [ref for outputs in got.values() for _, ref in outputs]
        got = {name: [(ours, exact.pop(0)) for ours, _ in outputs] for name, outputs in got.items()}
        tol, against = exact_tol, "fp64"
        plain_share, gap = 0.0, 0.0
        for (ours, ref), p in zip((pair for outputs in got.values() for pair in outputs), plains):
            a, b, pv = ours[valid].double(), ref[valid], p[valid].double()
            plain_share = max(plain_share, ((pv - b).abs() / (tol + tol * b.abs())).max().item())
            gap = max(gap, (a - pv).abs().max().item())
        note = f"; the plain fp32 version {plain_share:.3f} of it, the kernels {gap:.3g} from the plain version"
    errs, share, hi = {}, 0.0, torch.float32 if exact_tol is None else torch.float64
    for name, outputs in got.items():
        for ours, ref in outputs:
            a, b = ours[valid].to(hi), ref[valid].to(hi)
            err = (a - b).abs().max().item()
            check(torch.allclose(a, b, atol=tol, rtol=tol), f"{name} vs {against} at {where} {shape} {dname}: "
                                                            f"err {err}")
            check(bool(torch.all(ours[~valid] == 0)), f"{name} not zero on padding rows at {where} {shape}")
            errs[name] = max(errs.get(name, 0.0), err)
            # the worst error as a share of what allclose allows there
            share = max(share, ((a - b).abs() / (tol + tol * b.abs())).max().item())
    for dense_name, pruned_name, _, _ in pairs:
        errs[pruned_name] = errs[dense_name]
    print(f"[held] {where} {shape} {dname}: " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" max_abs_err vs {against} (tol {tol}; {share:.3f} of the allowance{note}), lse {lerr:.3g} "
          + "(tol 2e-05); " + ("K4 == K1, K5 == K2, K6 == K3" if backward else "K4 == K1")
          + " bitwise, padding rows zero")
    return errs


def hold_kernels(rng, where: str, seg_np, causal: bool = True, backward: bool = True,
                 exact_tol: float | None = None, **widths) -> dict:
    """compare_kernels in both dtypes on seeded q, k, v and cotangent at the
    segment ids ``seg_np`` (a parity case's, or those a run of the main path
    gave its attention), with the head layout and q scale ``widths``
    (bwd_case's options), fp32 against fp64 at ``exact_tol`` where it is
    given; returns the bf16 errors."""
    import torch

    errs = {}
    for dname in ("float32", "bfloat16"):
        args, blk = bwd_case(rng, seg_np, getattr(torch, dname), causal=causal, **widths)
        errs = compare_kernels(args, blk, causal, dname, where, backward,
                               exact_tol if dname == "float32" else None)
        del args
    torch.cuda.empty_cache()
    return errs


def phase_backward(rng, train_seg):
    """K1-K6 against their plain versions at every flash case in both dtypes
    (compare_kernels: K5 == K2, K6 == K3 bitwise, zero gradients on
    all-padding rows); returns the bf16 errors."""
    max_err = {name: 0.0 for pair in BWD_PAIRS for name in pair}
    for label, seg_np, extra in flash_cases(rng, train_seg):
        errs = hold_kernels(rng, f"[backward] {label}", seg_np, **extra)
        max_err = {name: max(err, errs[name]) for name, err in max_err.items()}
    return max_err


def record_prefill(engine, sink: list | None = None, segments: list | None = None) -> None:
    """Keep every prefill call's picked logits (the engine discards them) in
    ``sink`` and its segment ids, as numpy, in ``segments``."""
    lookup = engine._prefill_fn

    def wrapped(shape):
        fn = lookup(shape)

        def call(*args):
            picked, caches = fn(*args)
            if sink is not None:
                sink.append(picked.detach().clone())
            if segments is not None:
                segments.append(args[4].cpu().numpy())  # params, caches, tokens, positions, segments
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
    from repro_torch.kernels import adamw
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
    adamw.reset_launches()
    t0 = time.perf_counter()
    state, steps = trainer.train_epoch(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - sum(hash_s)
    del loader.epoch, loader.streaming_epoch
    launches = dict(fa.LAUNCHES)
    adamw_launches = dict(adamw.LAUNCHES)
    tracer.disable()
    events = tracer.events()
    step_s = [e["dur"] / 1e6 - h for e, h in
              zip([e for e in events if e["name"] == "train/step"], hash_s)]
    phases = step_phases(events, hash_s)
    tokens = reg.flat()["train_tokens_total"]
    adamw_total = reg.flat().get("kernel_adamw_launches_total", 0)
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
    want = {name: steps * k for name, k in ADAMW_STEP_LAUNCHES.items()}
    check(adamw_launches == want and adamw_total == sum(want.values()),
          f"{tag}: AdamW launches {adamw_launches}, kernel_adamw_launches_total {adamw_total}; "
          f"want {want} ({steps} steps of {ADAMW_STEP_LAUNCHES})")
    print(f"{tag}: AdamW launches {adamw_launches}, kernel_adamw_launches_total {adamw_total:.0f} "
          f"({steps} steps, every one through the kernel)")
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
    return dict(launches=launches, adamw_launches=adamw_launches,
                losses=[r["loss"] for r in trainer.history],
                grad_norms=[r["grad_norm"] for r in trainer.history], step_s=step_s,
                tokens_per_s=tokens / wall, tokens_per_s_2_4=tokens_2_4, peak_gib=peak / 2**30,
                digests=digests, phases=phases)


def phase_training() -> dict:
    """Full-width training on the default (pruned) route over three data
    paths, then on the dense route from the same weights and data; returns
    the kernels' launches, each from its own route's default-path run, and
    the AdamW kernels' (under ``"adamw"``) from the pruned default-path run."""
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
    launches["adamw"] = pruned["adamw_launches"]
    return launches


def visible_pairs(seg, causal: bool = True) -> int:
    """The (query, key) pairs that the (causal) segment mask lets through,
    summed over the batch rows: the work the attention function needs, which
    a live tile's masked entries (above the diagonal, across segments) add
    nothing to."""
    import torch

    pos = torch.arange(seg.shape[1], device=seg.device)
    order = (pos[None, :] <= pos[:, None]) | (not causal)
    return sum(int((order & (row[None, :] == row[:, None]) & (row[None, :] > 0)).sum())
               for row in seg)


def sdpa_inputs(q, k, v, seg, causal: bool = True):
    """The SDPA yardstick's (B, H, S, D) layout, kv heads repeated, and the
    same visibility as a boolean mask (rows with no visible key are padding)."""
    import torch

    cap = q.shape[1]
    pos = torch.arange(cap, device="cuda")
    mask = (((pos[None, :] <= pos[:, None]) | (not causal))[None]
            & (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None]
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


def phase_times_training(rng, train_seg, heads=HEADS, kv_heads=KV_HEADS, d_head=D_HEAD,
                         causal=True, label="training step 1") -> dict:
    """Every kernel at the first training step's shape (bf16), first held
    against the plain version on the timed inputs (compare_kernels), then
    timed: each pass of the backward alone through its C entry point, the
    plain version, the
    SDPA yardstick (its forward for K1/K4, its backward for the backward
    kernels) and the bound (4, 6 or 8 D FLOPs per visible (query, key) pair
    and head for the forward, dQ and dK/dV; each input read once, each output
    written once).  The widths and mask default to the training run's;
    ``label`` names the shape in the printed lines."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.kernels.ref import segment_flash_attention_bwd_ref, segment_flash_attention_ref

    widths = dict(heads=heads, kv_heads=kv_heads, d_head=d_head)
    (q, k, v, seg, out, lse, do), blk = bwd_case(rng, train_seg, torch.bfloat16, causal=causal, **widths)
    rows, cap = train_seg.shape
    errs = compare_kernels((q, k, v, seg, out, lse, do), blk, causal, "bfloat16", f"[times] {label}")
    tables = build_liveness_tables(seg, block_q=blk, block_kv=blk, causal=causal)
    live = int(tables.kv_count.sum()) * heads  # live (row, q-head, tile) triples
    pairs = visible_pairs(seg, causal) * heads  # visible (row, q-head, query, key)
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = build.load_library("flash_bwd")
    dims = (rows, cap, heads, kv_heads, d_head, blk, blk, int(causal), 1.0 / d_head**0.5,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    ptr = build.launch_arg
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

    elem = rows * cap * d_head  # elements of one head's (rows, cap, D) slab
    qo_bytes, kv_bytes = 2 * elem * heads, 2 * elem * kv_heads
    stat_bytes = 4 * rows * cap * heads  # one fp32 (rows, cap, H) statistic
    seg_bytes = 4 * rows * cap
    work = {  # name -> (FLOPs, bytes read once + written once)
        "fwd": (4.0 * d_head * pairs, 2 * qo_bytes + 2 * kv_bytes + stat_bytes + seg_bytes),
        "dq": (6.0 * d_head * pairs, 3 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes + seg_bytes),
        "dkv": (8.0 * d_head * pairs, 2 * qo_bytes + 4 * kv_bytes + 2 * stat_bytes + seg_bytes),
    }
    qt, kt, vt, mask = sdpa_inputs(q, k, v, seg, causal)
    t_lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters=10)
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_do = do.transpose(1, 2).contiguous()
    t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True),
                        iters=5, warmup=1)
    del lib_out, qt, kt, vt, mask
    t_plain_fwd = cuda_ms(lambda: segment_flash_attention_ref(q, k, v, seg, causal, return_lse=True),
                          iters=3, warmup=1)
    t_plain_bwd = cuda_ms(lambda: segment_flash_attention_bwd_ref(q, k, v, seg, out, lse, do, causal),
                          iters=3, warmup=1)
    torch.cuda.empty_cache()
    kw = dict(block_q=blk, block_kv=blk, return_lse=True, causal=causal)
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
        print(f"[times] {name} rows={rows} cap={cap} block={blk} heads={heads}/{kv_heads} "
              f"d_head={d_head} causal={causal} bf16 ({label}): kernel_ms "
              f"{ms:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.5f} ({bound_by}) live tiles {live} visible pairs {pairs} "
              f"achieved {flops / ms / 1e9:.2f} TFLOP/s, bound share {r['bound_ms'] / ms:.4f}, "
              f"kernel/library {ms / r['library_ms']:.3f}")
    return dict(result, shape=[rows, cap, heads, kv_heads, d_head], causal=causal, block=blk,
                live_tiles=live, visible_pairs=pairs, max_abs_err=errs)


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


# -- chaos: the harness matrix, faults through training, comparators, census -------


def chaos_matrix() -> None:
    """(a) ``repro_torch.chaos.run_all`` at CHAOS_SEEDS, every rail held."""
    from repro_torch.chaos import run_all

    for seed in CHAOS_SEEDS:
        for kind, res in run_all(seed).items():
            what = f"[chaos] (a) seed {seed} {kind}: {res.as_dict()}"
            check(res.terminated and res.within_bound and res.ok, what)
            if kind == "gather_drop":
                check(res.details["aborted"], what)
            check(not res.bit_exact and res.accounted if kind == "poison_sample" else res.bit_exact,
                  what)
            print(f"[chaos] (a) seed {seed} {kind}: rounds {res.rounds} bound {res.bound} "
                  f"wall {res.wall_s:.4f}s bit_exact {res.bit_exact} accounted {res.accounted} "
                  f"details {res.details}")


def chaos_run(trainer, loader, name: str, config, *, injector=None, poison=None) -> dict:
    """TRAIN_STEPS steps from seed-0 weights and zero AdamW moments, taken as
    the trainer takes them: ``loader.streaming_epoch(prefetch=True,
    device_put=True, fault_injector=...)`` -> ``assemble_model_batch`` -> the
    trainer's step.  An ``EpochAborted`` continues from its checkpoint
    (through JSON) with no injector.  Each step's ``stream_digest`` and host
    arrays' sha256 are taken as the step reaches the consumer."""
    import contextlib
    import math

    import torch

    from repro_torch import obs
    from repro_torch.chaos import poison_samples, stream_digest
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.stream import EpochAborted, StreamCheckpoint
    from repro_torch.train.trainer import assemble_model_batch

    loader.config = config
    device = trainer.model.device
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    obs.default_registry().reset()
    fa.reset_launches()
    rec = dict(loss=[], grad_norm=[], groups=[], stream=[], host=[], aborted=False,
               resume_step=None)
    resume = None
    t0 = time.perf_counter()
    with poison_samples(poison) if poison is not None else contextlib.nullcontext():
        while len(rec["loss"]) < TRAIN_STEPS:
            steps = loader.streaming_epoch(
                prefetch=True, device_put=True, device=device, resume_from=resume,
                fault_injector=injector if resume is None else None)
            try:
                for loader_step in steps:
                    batch = assemble_model_batch(loader_step, loader.layout, device)
                    state, metrics = trainer._train_step(state, batch)
                    rec["loss"].append(float(metrics["loss"]))
                    rec["grad_norm"].append(float(metrics["grad_norm"]))
                    rec["groups"].append(loader_step.groups)
                    rec["stream"].append(stream_digest([loader_step.groups]))
                    rec["host"].append(step_digest(loader_step, loader.layout))
                    if len(rec["loss"]) == TRAIN_STEPS:
                        break
                else:
                    check(False, f"[chaos] (b) {name}: the epoch ended after {len(rec['loss'])} steps")
            except EpochAborted as exc:
                check(resume is None, f"[chaos] (b) {name}: aborted after its resume")
                rec["aborted"] = True
                rec["resume_step"] = loader.last_executor.runner.steps_delivered
                resume = StreamCheckpoint.from_json(exc.checkpoint().to_json())
            finally:
                steps.close()  # the consumer's boundary; drains the epoch's schedule
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = dict(fa.LAUNCHES)
    n = trainer.model.cfg.n_layers * TRAIN_STEPS
    want = {**dict.fromkeys(fa.LAUNCHES, 0), "segment_flash_attention_pruned": 2 * n,
            "segment_flash_attention_bwd_pruned_dq": n, "segment_flash_attention_bwd_pruned_dkv": n}
    check(rec["launches"] == want, f"[chaos] (b) {name}: launches {rec['launches']} != {want}")
    rec["rounds"] = loader.last_executor.runner.rounds
    rec["audit"] = loader.last_audit
    rec["quarantined"] = set(loader.last_executor.runner.quarantined_ids)
    rec["flat"] = obs.default_registry().flat()
    rec["combined"] = stream_digest(rec.pop("groups"))
    for i, (loss, gn) in enumerate(zip(rec["loss"], rec["grad_norm"])):
        check(math.isfinite(loss) and math.isfinite(gn),
              f"[chaos] (b) {name} step {i + 1}: loss {loss} grad_norm {gn}")
    check(len(rec["loss"]) == TRAIN_STEPS, f"[chaos] (b) {name}: {len(rec['loss'])} steps")
    print(f"[chaos] (b) {name}: {len(rec['loss'])} steps, rounds {rec['rounds']}, wall "
          f"{rec['wall_s']:.3f}s (the epoch's drain after the last step included), K4/K5/K6 "
          f"launches {want['segment_flash_attention_pruned']}/{n}/{n}, losses "
          f"{rec['loss']}, grad_norm {rec['grad_norm']}, stream digests "
          f"{[d[:12] for d in rec['stream']]}")
    del state
    torch.cuda.empty_cache()
    return rec


def chaos_drop_round(loader, config) -> int:
    """A primary gather round that the producer reaches while it builds step
    3 or 4, found by a host-only pass over the same epoch: the drop then
    fires with steps staged on the card ahead of the consumer."""
    seen: dict[int, int] = {}

    class Recorder:
        def on_gather(self, round_index, attempt, rank, tag):
            if tag == "primary":
                seen.setdefault(round_index, loader.last_executor.runner.steps_delivered)

    loader.config = config
    steps = loader.streaming_epoch(fault_injector=Recorder(), finalize_audit=False)
    try:
        for i, _ in enumerate(steps):
            if i + 1 == TRAIN_STEPS:
                break
    finally:
        steps.close()
    late = [r for r, delivered in sorted(seen.items()) if delivered in (2, 3)]
    check(bool(late), f"[chaos] (b) no gather round while building step 3 or 4: {seen}")
    print(f"[chaos] (b) primary rounds -> steps delivered before them: {seen}; drop at round "
          f"{late[0]}")
    return late[0]


def chaos_training(trainer, loader) -> dict:
    """(b) The fault-free run twice, then a transient gather_delay, a hard
    gather_drop (abort and resume) and poison samples, all on the training
    run's cell with CHAOS_TRAIN_ARGS' round structure.  Returns K4-K6's
    launches in one run."""
    import dataclasses as dc

    from repro_torch.chaos import ChaosPlan, CollectiveInjector

    tag = "[chaos] (b)"
    base = dc.replace(loader.config, round_deadline_s=CHAOS_DEADLINE_S, round_retries=2)
    layout_step = loader._layout_step

    def with_groups(index, step):  # the groups travel with the step, for stream_digest
        built = layout_step(index, step)
        built.groups = step
        return built

    loader._layout_step = with_groups
    try:
        ff = [chaos_run(trainer, loader, f"fault-free {i + 1}", base) for i in range(2)]
        launches = {k: v for k, v in ff[0]["launches"].items() if "pruned" in k}
        # The standard for the fault runs: bitwise when the pair is bitwise,
        # else within the pair's largest absolute difference of that metric.
        bitwise = all(ff[0][k] == ff[1][k] for k in ("loss", "grad_norm"))
        spread = {k: max(abs(a - b) for a, b in zip(ff[0][k], ff[1][k]))
                  for k in ("loss", "grad_norm")}
        check(ff[0]["stream"] == ff[1]["stream"] and ff[0]["host"] == ff[1]["host"],
              f"{tag} the fault-free pair delivered different steps")
        print(f"{tag} the fault-free pair: losses and grad_norm bitwise equal: {bitwise} "
              f"(largest absolute difference {spread})")

        def cost(rec):  # against the second fault-free run: the first carries the warm-up
            return (f"{rec['wall_s'] / ff[1]['wall_s']:.3f}x the fault-free run's wall "
                    f"({rec['wall_s']:.3f} / {ff[1]['wall_s']:.3f} s)")

        def held(rec, name):
            check(rec["stream"] == ff[0]["stream"] and rec["host"] == ff[0]["host"],
                  f"{tag} {name}: step digests {rec['stream']} != {ff[0]['stream']}")
            for k in ("loss", "grad_norm"):
                for i, (a, b) in enumerate(zip(rec[k], ff[0][k])):
                    check(a == b if bitwise else abs(a - b) <= spread[k],
                          f"{tag} {name} step {i + 1}: {k} {a} vs the fault-free {b} "
                          f"({'bitwise' if bitwise else f'spread {spread[k]}'})")

        plan = ChaosPlan(0, loader.world_size)
        delay = CollectiveInjector(plan, kind="gather_delay", rate=1.0, max_delay_s=CHAOS_MAX_DELAY_S)
        rec = chaos_run(trainer, loader, "gather_delay", base, injector=delay)
        retries = rec["flat"].get("odb_fault_retries_total", 0)
        recovered = rec["flat"].get("odb_fault_recovered_total", 0)
        check(delay.injected > 0 and retries > 0 and recovered > 0 and not rec["aborted"],
              f"{tag} gather_delay: injected {delay.injected} retries {retries} recovered "
              f"{recovered} aborted {rec['aborted']}")
        held(rec, "gather_delay")
        print(f"{tag} gather_delay (deadline {CHAOS_DEADLINE_S}s, delays up to {CHAOS_MAX_DELAY_S}s "
              f"at rate 1, attempt 0 only): over the epoch, its drain included, {delay.injected} "
              f"delays injected, {retries:.0f} retries, {recovered:.0f} gathers recovered; digests "
              f"and losses "
              f"{'bitwise equal to' if bitwise else 'within the spread of'} the fault-free run's; "
              f"recovery cost {cost(rec)}")

        drop_cfg = dc.replace(base, round_retries=1)
        at_round = chaos_drop_round(loader, drop_cfg)

        class Watched(CollectiveInjector):
            """The drop, and the steps staged on the card ahead of the
            consumer when it first fires."""

            staged = None

            def on_gather(self, *site):
                out = super().on_gather(*site)
                if out == "drop" and self.staged is None:
                    stats = loader.last_prefetch_stats
                    self.staged = stats.produced - stats.consumed
                return out

        drop = Watched(plan, kind="gather_drop", at_round=at_round)
        rec = chaos_run(trainer, loader, "gather_drop", drop_cfg, injector=drop)
        check(rec["aborted"] and drop.staged is not None and drop.staged >= 1,
              f"{tag} gather_drop: aborted {rec['aborted']}, staged at the drop {drop.staged}")
        check(rec["audit"].coverage_accounted, f"{tag} gather_drop: audit {rec['audit']}")
        held(rec, "gather_drop")
        check(rec["combined"] == ff[0]["combined"], f"{tag} gather_drop: combined digest")
        print(f"{tag} gather_drop at round {at_round} (retries 1): EpochAborted with "
              f"{drop.staged} step(s) staged on the card ahead of the consumer, resumed from "
              f"exc.checkpoint() after step {rec['resume_step']}; combined stream "
              f"digest {rec['combined'][:16]} equal to the fault-free run's, no step lost or "
              f"taken twice; losses {'bitwise equal' if bitwise else 'within the spread'}; "
              f"recovery cost {cost(rec)}")

        n = len(loader.dataset.records(loader.seed))
        poison = plan.poison_identities(n, count=CHAOS_POISON)
        rec = chaos_run(trainer, loader, "poison_sample",
                        dc.replace(base, max_quarantine=CHAOS_POISON), poison=poison)
        audit = rec["audit"]
        check(audit.coverage_accounted and rec["quarantined"] == set(poison)
              and audit.quarantined_identities == len(poison),
              f"{tag} poison_sample: quarantined {sorted(rec['quarantined'])} vs the plan's "
              f"{sorted(poison)}, audit {audit}")
        print(f"{tag} poison_sample ({sorted(poison)} of {n} records, max_quarantine "
              f"{CHAOS_POISON}): the epoch ran to its end, coverage_accounted, quarantined "
              f"identities equal the plan's; every loss finite; wall {cost(rec)}")
    finally:
        del loader._layout_step
        loader.config = base
    return launches


def step_slots(layout, step) -> int:
    return sum(b.tokens.size for b in layout.build_step(step))


def chaos_comparators(trainer, loader) -> dict:
    """(c) Every comparator's schedule for the training run's data at world
    2, the cut sizes checked against CELL_SLOTS; one full-width step on the
    first step of Standard (dense layout, flash pinned: K1-K3) and of GMT
    (packed: K4-K6).  Returns K1-K3's launches in the Standard step."""
    import dataclasses as dc
    import math

    import torch

    from repro_torch.core import OdbConfig
    from repro_torch.core.layout import make_layout
    from repro_torch.core.metadata import step_metadata
    from repro_torch.data import (
        LengthCache, LoaderStep, bmt_schedule, gmt_schedule, hfg_schedule, odb_schedule,
        packing_schedule, sorted_schedule, standard_schedule,
    )
    from repro_torch.data.baselines import packed_area
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.trainer import assemble_model_batch, make_train_step

    tag = "[chaos] (c)"
    world, cut = loader.world_size, COMPARATOR_CUT
    print(f"{tag} SELECTED[ultrachat, 2b] {COMPARATOR_SELECTED} cut to {cut} (largest step at "
          f"most {CELL_SLOTS} token slots on the method's layout), world {world}")
    ds = loader.dataset
    t = time.perf_counter()
    lengths = ds.lengths(seed=loader.seed)
    lengths_s = time.perf_counter() - t
    cache = LengthCache.build(ds, seed=loader.seed)
    dense = make_layout("dense", bucket_spec=loader.bucket_spec, vocab_size=loader.vocab_size)
    packed = loader.layout
    cell = train_launcher.parser().parse_args(TRAIN_ARGS)  # ODB as the training run admits
    odb_cfg = OdbConfig(l_max=cut["lmax"], buffer_size=cell.buffer, prefetch_factor=cell.prefetch,
                        num_workers=4)
    methods = {
        "standard": (dense, lambda: standard_schedule(lengths, world, cut["std_bs"], seed=loader.seed)),
        "sorted": (dense, lambda: sorted_schedule(lengths, world, cut["sorted_bs"], seed=loader.seed)),
        "packing": (packed, lambda: packing_schedule(lengths, world, cut["budget"], seed=loader.seed)),
        "gmt": (packed, lambda: gmt_schedule(cache, world, cut["budget"])),
        "bmt": (packed, lambda: bmt_schedule(cache, world, cut["budget"], seed=loader.seed)),
        "hfg": (dense, lambda: hfg_schedule(cache, world, cut["hfg_bs"], seed=loader.seed)),
        "odb": (packed, lambda: odb_schedule(lengths, world, odb_cfg, seed=loader.seed)[0]),
    }
    firsts = {}
    for name, (layout, build) in methods.items():
        t = time.perf_counter()
        steps = build()
        build_s = time.perf_counter() - t
        groups = [g for step in steps for g in step if g is not None]
        slots = [step_slots(layout, step) for step in steps]
        check(max(slots) <= CELL_SLOTS, f"{tag} {name}: a step of {max(slots)} token slots")
        padded = (sum(packed_area(g, cut["budget"]) for g in groups) if name == "packing"
                  else sum(g.padded_tokens for g in groups))
        print(f"{tag} {name}: {len(steps)} steps, real tokens {sum(g.real_tokens for g in groups)}, "
              f"padded tokens {padded} ({'windows' if name == 'packing' else 'size x longest'}), "
              f"{layout.name} layout slots {sum(slots)} (largest step {max(slots)}), build "
              f"{build_s:.4f}s" + (f" (the length cache took {cache.build_seconds:.4f}s, excluded)"
                                   if name in ("gmt", "bmt", "hfg") else
                                   f" (+ lengths {lengths_s:.4f}s)" if name != "odb" else ""))
        firsts[name] = steps[0]

    model, cfg0 = trainer.model, trainer.model.cfg
    opt_cfg = trainer.opt_cfg
    want = {"standard": ("segment_flash_attention", "segment_flash_attention_bwd_dq",
                         "segment_flash_attention_bwd_dkv"),
            "gmt": ("segment_flash_attention_pruned", "segment_flash_attention_bwd_pruned_dq",
                    "segment_flash_attention_bwd_pruned_dkv")}
    try:
        for name, layout, grid in (("standard", dense, "dense"), ("gmt", packed, "pruned")):
            model.cfg = dc.replace(cfg0, attn_impl="flash", attn_grid=grid)
            state = trainer.init_state(torch.Generator(device=model.device).manual_seed(0))
            step = firsts[name]
            loader_step = LoaderStep(batches=layout.build_step(step), metadata=step_metadata(0, step))
            batch = assemble_model_batch(loader_step, layout, model.device)
            shape = tuple(batch["tokens"].shape)
            torch.cuda.synchronize()
            fa.reset_launches()
            t = time.perf_counter()
            state, metrics = make_train_step(model, opt_cfg)(state, batch)
            loss = float(metrics["loss"])
            ms = 1e3 * (time.perf_counter() - t)
            launches = dict(fa.LAUNCHES)
            if name == "standard":
                dense_launches = {k: launches[k] for k in want[name]}
            fwd, dq, dkv = want[name]
            n = cfg0.n_layers
            check(launches == {**dict.fromkeys(launches, 0), fwd: 2 * n, dq: n, dkv: n},
                  f"{tag} {name}: launches {launches}")
            check(math.isfinite(loss) and math.isfinite(float(metrics["grad_norm"])),
                  f"{tag} {name}: loss {loss}")
            print(f"{tag} one full-width step on {name}'s first step ({layout.name} layout, "
                  f"tokens {shape}, attn_grid {grid}): loss {loss}, grad_norm "
                  f"{float(metrics['grad_norm'])}, {ms:.1f} ms (one run, its first call at this "
                  f"shape; not a benchmark), launches {launches}")
            del state, batch
            torch.cuda.empty_cache()
    finally:
        model.cfg = cfg0
    return dense_launches


def chaos_census(train_seg) -> None:
    """(d) The tile census on the training run's first step against the
    liveness tables built on the card and the dense grid's causal rule."""
    import torch

    from repro_torch.kernels.autotune import heuristic_blocks
    from repro_torch.kernels.flash_attention import live_tile_counts
    from repro_torch.kernels.liveness import build_liveness_tables, fetched_tile_counts

    tag = "[chaos] (d)"
    rows, s = train_seg.shape
    bq, bkv = heuristic_blocks(s)
    t = time.perf_counter()
    census = live_tile_counts(train_seg, s, bq, bkv)
    census_s = time.perf_counter() - t
    seg = torch.from_numpy(train_seg).cuda()
    tables = build_liveness_tables(seg, block_q=census["block_q"], block_kv=census["block_kv"])
    table_live = int(tables.kv_count.sum())
    check(census["segment_live"] == table_live == int(tables.q_count.sum()),
          f"{tag} segment_live {census['segment_live']} vs the tables' {table_live}")
    nq, nk = s // census["block_q"], s // census["block_kv"]
    qb = torch.arange(nq, device="cuda")[:, None] * census["block_q"]
    kb = torch.arange(nk, device="cuda")[None, :] * census["block_kv"]
    dense_causal = rows * int((qb + census["block_q"] - 1 >= kb).sum())  # flash_fwd.cu's test
    check(census["causal_live"] == dense_causal,
          f"{tag} causal_live {census['causal_live']} vs the dense grid's {dense_causal}")
    fetched = fetched_tile_counts(train_seg, s, bq, bkv, heads=HEADS, kv_heads=KV_HEADS,
                                  head_dim=D_HEAD, itemsize=2)
    check(fetched["pruned_fetches"] < fetched["dense_fetches"]
          and fetched["live_tiles"] == table_live, f"{tag} fetch census {fetched}")
    print(f"{tag} step 1 segments {tuple(train_seg.shape)}, blocks ({census['block_q']}, "
          f"{census['block_kv']}): live_tile_counts {census} ({census_s:.3f}s); segment_live equals "
          f"the card's tables ({table_live}), causal_live the dense grid's causal tiles "
          f"({dense_causal}); fetched_tile_counts (the TPU pipeline's re-fetch rule, kept for "
          f"parity): dense {fetched['dense_fetches']} pruned {fetched['pruned_fetches']} of "
          f"{fetched['grid_steps']} grid steps, {fetched['dense_fetched_bytes']} vs "
          f"{fetched['pruned_fetched_bytes']} kv bytes")


def phase_chaos(train_seg) -> dict:
    """(a) the harness matrix, (b) faults through full-width packed
    training, (c) the comparators and one step on two of them, (d) the tile
    census against the card's tables.  Returns the flash kernels' launches:
    K4-K6 in one run of (b), K1-K3 in (c)'s Standard step."""
    import torch

    from repro_torch.launch import train as train_launcher

    t = time.perf_counter()
    chaos_matrix()
    print(f"[chaos] (a) {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(CHAOS_TRAIN_ARGS))
    trainer._build_step()  # pins the route as train_epoch does: flash on the pruned grid
    check((trainer.attn_impl, trainer.attn_grid) == ("flash", "pruned"),
          f"[chaos] route {trainer.attn_impl}/{trainer.attn_grid}")
    launches = chaos_training(trainer, loader)
    print(f"[chaos] (b) {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    launches.update(chaos_comparators(trainer, loader))
    print(f"[chaos] (c) {time.perf_counter() - t:.1f}s")
    del trainer, loader
    torch.cuda.empty_cache()
    t = time.perf_counter()
    chaos_census(train_seg)
    print(f"[chaos] (d) {time.perf_counter() - t:.1f}s")
    return launches


def free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def arch_olmo_train(rng) -> dict:
    """Full-width OLMo-1B: ARCH_TRAIN_STEPS steps through the train launcher
    (packed, the pruned route: K4 twice per layer with remat, K5 and K6
    once), then one step's loss and gradients on the pruned and the dense
    grid from the trained weights, which must be bitwise equal, and K1-K6
    held against their plain versions at step 1's segment ids and OLMo's
    heads."""
    import math

    import torch

    from repro_torch import obs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import Trainer, assemble_model_batch

    t_run = time.perf_counter()
    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(ARCH_TRAIN_ARGS))
    model = trainer.model
    cfg = model.cfg
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[archs] {cfg.name} train: {cfg.n_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} norm {cfg.norm} "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params {cfg.dtype}")
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
    check(steps == ARCH_TRAIN_STEPS, f"{cfg.name}: {steps} steps run")
    for rec in trainer.history:
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{cfg.name} step {rec['step']}: loss {rec['loss']} grad_norm {rec['grad_norm']}")
        print(f"[archs] {cfg.name} {Trainer.format_log_line(rec)}")
    n = cfg.n_layers * steps
    want = {**dict.fromkeys(launches, 0), "segment_flash_attention_pruned": 2 * n,
            "segment_flash_attention_bwd_pruned_dq": n, "segment_flash_attention_bwd_pruned_dkv": n}
    check(launches == want, f"{cfg.name} train launches {launches} != {want}")
    loss_tokens = [rec["tokens"] for rec in trainer.history]
    print(f"[archs] {cfg.name} train: tokens/s {tokens / wall:.1f} ({tokens:.0f} real tokens in "
          f"{wall:.3f}s), loss tokens/s over steps 2..{steps} {sum(loss_tokens[1:]) / sum(step_s[1:]):.1f}, "
          f"step s {[round(t, 4) for t in step_s]}, max_memory_allocated {peak / 2**30:.3f} GiB, "
          f"launches {launches}")

    steps_iter = loader.epoch(0)
    first = next(steps_iter)
    steps_iter.close()
    batch = assemble_model_batch(first, loader.layout, model.device)
    leaves = tree_leaves(state["params"])
    pinned, results = model.cfg, {}
    for grid in ("pruned", "dense"):
        model.cfg = dataclasses.replace(pinned, attn_grid=grid)
        loss_sum, count = model.loss_sums(state["params"], batch)
        results[grid] = (loss_sum.detach(), torch.autograd.grad(loss_sum / count, leaves))
    model.cfg = pinned
    (lp, gp), (ld, gd) = results["pruned"], results["dense"]
    check(torch.equal(lp, ld) and all(torch.equal(a, b) for a, b in zip(gp, gd)),
          f"{cfg.name}: the pruned and dense grids differ on step 1 (loss {lp.item()} vs {ld.item()})")
    print(f"[archs] {cfg.name} step 1 {tuple(batch['tokens'].shape)}: pruned == dense bitwise, loss sum "
          f"{lp.item():.6f} and all {len(gp)} gradients; {time.perf_counter() - t_run:.1f}s in all")
    losses = [rec["loss"] for rec in trainer.history]
    seg_np = batch["segments"].cpu().numpy()
    del trainer, loader, model, state, results, gp, gd, batch, leaves
    free_cuda()
    errs = hold_kernels(rng, f"{cfg.name} step 1", seg_np, causal=cfg.causal, heads=cfg.n_heads,
                        kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
    return dict(launches=launches, tokens_per_s=tokens / wall, step_s=step_s, peak_gib=peak / 2**30,
                losses=losses, max_abs_err=errs)


def arch_hubert(rng) -> dict:
    """Full-width HuBERT-XLarge on a packed batch of frame embeddings
    (HUBERT_ROWS x HUBERT_FRAMES, bf16): one ``loss_sums`` with the
    gradients of the mean loss (K4 twice per layer with remat, K5 and K6
    once, all bidirectional at d_head 80), one encode (``LM.forward`` under
    no_grad: K4 once per layer), and the loss on the dense grid bitwise
    equal to the pruned grid's; then K1-K6 held against their plain
    versions at the batch's segment ids and HuBERT's heads."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import LM
    from repro_torch.models.model import padded_vocab
    from repro_torch.train.optimizer import global_norm, tree_leaves

    cfg = get_config("hubert_xlarge")
    model = LM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    seg_np, pos_np = long_segments(rng, HUBERT_ROWS, HUBERT_FRAMES)
    gen = torch.Generator(device="cuda").manual_seed(1)
    segments = torch.from_numpy(seg_np).cuda()
    batch = dict(
        embeds=torch.randn((HUBERT_ROWS, HUBERT_FRAMES, cfg.d_model), generator=gen, device="cuda")
        .to(torch.bfloat16),
        positions=torch.from_numpy(pos_np).cuda(), segments=segments,
        labels=torch.randint(0, cfg.vocab_size, (HUBERT_ROWS, HUBERT_FRAMES), generator=gen, device="cuda"),
        loss_mask=(segments > 0).float(),
    )
    leaves = tree_leaves(params)
    print(f"[archs] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_head {cfg.d_head} causal {cfg.causal} norm {cfg.norm} act {cfg.act} "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params {cfg.dtype}; batch "
          f"{HUBERT_ROWS} x {HUBERT_FRAMES} frames, {int(seg_np.max())} segments in a row at most, "
          f"{int((seg_np > 0).sum())} valid frames")

    def loss_and_grads():
        loss_sum, count = model.loss_sums(params, batch)
        return (loss_sum / count).detach(), torch.autograd.grad(loss_sum / count, leaves)

    loss_and_grads()  # the first call at this shape: cuBLAS handles, the allocator's pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t = time.perf_counter()
    loss, grads = loss_and_grads()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = dict(fa.LAUNCHES)
    gnorm = global_norm(list(grads)).item()
    peak = torch.cuda.max_memory_allocated()
    del grads
    n = cfg.n_layers
    want = {**dict.fromkeys(launches, 0), "segment_flash_attention_pruned": 2 * n,
            "segment_flash_attention_bwd_pruned_dq": n, "segment_flash_attention_bwd_pruned_dkv": n}
    check(launches == want, f"{cfg.name} loss launches {launches} != {want}")
    check(math.isfinite(loss.item()) and math.isfinite(gnorm), f"{cfg.name}: loss {loss} grad norm {gnorm}")
    frames = int((seg_np > 0).sum())
    with torch.no_grad():
        model.forward(params, batch)
        torch.cuda.synchronize()
        fa.reset_launches()
        t = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t
        encode_launches = dict(fa.LAUNCHES)
        valid = segments > 0
        check(bool(torch.isfinite(logits[valid][:, :cfg.vocab_size]).all()), f"{cfg.name}: encode not finite")
        check(tuple(logits.shape) == (HUBERT_ROWS, HUBERT_FRAMES, padded_vocab(cfg.vocab_size)),
              f"{cfg.name}: logits {tuple(logits.shape)}")
        check(encode_launches["segment_flash_attention_pruned"] == n, f"encode launches {encode_launches}")
        del logits
        pruned = model.loss_sums(params, batch)[0]
        model.cfg = dataclasses.replace(cfg, attn_grid="dense")
        dense = model.loss_sums(params, batch)[0]
        model.cfg = cfg
    check(torch.equal(pruned, dense), f"{cfg.name}: pruned loss {pruned.item()} != dense {dense.item()}")
    print(f"[archs] {cfg.name}: loss {loss.item():.6f} grad_norm {gnorm:.6f}, loss+grads "
          f"{1e3 * step_s:.1f} ms ({frames / step_s:.1f} frames/s), encode {1e3 * encode_s:.1f} ms "
          f"({frames / encode_s:.1f} frames/s), max_memory_allocated {peak / 2**30:.3f} GiB, launches "
          f"{launches} (encode: K4 {encode_launches['segment_flash_attention_pruned']}); the loss sum on "
          f"the dense grid == the pruned grid's bitwise ({pruned.item():.6f})")
    del model, params, batch, leaves
    free_cuda()
    errs = hold_kernels(rng, cfg.name, seg_np, causal=cfg.causal, heads=cfg.n_heads,
                        kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
    return dict(launches=launches, loss=loss.item(), grad_norm=gnorm, step_s=step_s, encode_s=encode_s,
                frames_per_s=frames / step_s, peak_gib=peak / 2**30, max_abs_err=errs)


def serve_checks(tag: str, cfg, engine, wall: float, launches: dict) -> dict:
    """Every request of ``engine`` finished with ids in the vocabulary, K4
    launched n_layers times per prefill call and K1 never; prints and
    returns tokens/s, tick ms and peak memory."""
    import torch

    st = engine.stats
    peak = torch.cuda.max_memory_allocated()
    check(st.finished == len(engine.requests), f"{tag}: {st.finished}/{len(engine.requests)} finished")
    check(all(0 <= t < cfg.vocab_size for r in engine.requests.values() for t in r.generated),
          f"{tag}: generated ids outside the vocabulary")
    check(launches["segment_flash_attention_pruned"] == st.prefill_calls * cfg.n_layers
          and launches["segment_flash_attention"] == 0,
          f"{tag}: launches {launches}, prefill calls {st.prefill_calls} x {cfg.n_layers} layers")
    print(f"{tag}: tokens/s {st.generated_tokens / wall:.1f} ({st.generated_tokens} tokens in "
          f"{wall:.3f}s), {st.ticks} ticks ({1e3 * wall / st.ticks:.2f} ms each), decode steps "
          f"{st.decode_steps}, prefill calls {st.prefill_calls}, max_memory_allocated "
          f"{peak / 2**30:.3f} GiB, launches {launches}")
    return dict(launches=launches, tokens_per_s=st.generated_tokens / wall, tick_ms=1e3 * wall / st.ticks,
                peak_gib=peak / 2**30)


def serve_holds(rng, cfg, segments: list) -> dict:
    """K1 and K4 held against the plain forward at each prefill bucket
    (rows, cap) that a serving run used, at its first call's segment ids,
    with the model's heads; returns the bf16 errors, the worst per kernel."""
    errs: dict = {}
    firsts = {}
    for seg in segments:
        firsts.setdefault(tuple(seg.shape), seg)
    for shape, seg in sorted(firsts.items()):
        got = hold_kernels(rng, f"{cfg.name} prefill bucket", seg, causal=cfg.causal, backward=False,
                           heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
        errs = {name: max(errs.get(name, 0.0), e) for name, e in got.items()}
    return errs


def arch_serve_launcher(rng, arch: str) -> dict:
    """The whole ``arch`` served as a user serves it, ``python -m
    repro_torch.launch.serve --arch <arch>`` with its defaults (the serving
    phase's trace, seed-0 weights); the launcher returns its engine and wall
    seconds.  K1 and K4 are then held against the plain forward at each
    prefill bucket the engine used (seeded packing: the launcher keeps no
    segment ids)."""
    import io

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher

    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with contextlib.redirect_stdout(out):
        engine, wall = serve_launcher.main(["--arch", arch])
    launches = dict(fa.LAUNCHES)
    for line in out.getvalue().splitlines():
        print(f"[archs] launch.serve --arch {arch}: {line}")
    cfg = engine.model.cfg
    print(f"[archs] {cfg.name} serve: {cfg.n_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} "
          f"{sum(p.numel() for p in engine.model.parameters()) / 1e9:.3f}B params {cfg.dtype}")
    result = serve_checks(f"[archs] {cfg.name} serve", cfg, engine, wall, launches)
    buckets = [packed_segments(rng, rows, cap) for rows, cap in engine.prefill_traces]
    del engine
    free_cuda()
    result["max_abs_err"] = serve_holds(rng, cfg, buckets)
    return result


def arch_serve_cut(rng, arch: str, layers: int) -> dict:
    """``arch`` at full width with its depth cut to ``layers`` serving the
    serving phase's whole trace through the engine (the launcher takes no
    depth); for an MoE model also the (token, expert) pairs dropped at
    capacity, in the first prefill and in the run.  K1 and K4 are then held
    against the plain forward at the segment ids of each prefill bucket's
    first call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import LM
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    t0 = time.perf_counter()
    model = LM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[archs] {cfg.name} serve: {cfg.n_layers} layers (depth cut from {get_config(arch).n_layers}) "
          f"d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff}"
          + (f" experts {cfg.n_experts} top-{cfg.top_k} moe_d_ff {cfg.moe_d_ff}" if cfg.n_experts else "")
          + f" {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f}s")
    trace = synth_request_trace(ARCH_SERVE_REQUESTS, vocab=cfg.vocab_size, prompt_min=8, prompt_max=96,
                                new_min=2, new_max=48, seed=0)
    engine = ContinuousBatchingEngine(model, params, ServeConfig(num_slots=8, max_len=256, l_max=1024,
                                                                 lookahead=32))
    segments: list = []
    record_prefill(engine, segments=segments)
    drops: list = []
    for p, n in trace:
        engine.submit(p, n)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with counted_drops(drops):
        t = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    result = serve_checks(f"[archs] {cfg.name} serve", cfg, engine, wall, dict(fa.LAUNCHES))
    if cfg.n_experts:
        pairs, capacity = drops[0][0], drops[0][1]
        result["first_prefill_drops"] = sum(d[2] for d in drops[:cfg.n_layers])
        result["run_drops"] = sum(d[2] for d in drops)
        print(f"[archs] {cfg.name} first prefill: {pairs} (token, expert) pairs a layer at capacity "
              f"{capacity}, {result['first_prefill_drops']} dropped over {cfg.n_layers} layer(s); "
              f"{result['run_drops']} of {sum(d[0] for d in drops)} pairs dropped over the run's "
              f"{len(drops) // cfg.n_layers} MoE calls a layer (prefills and decode steps)")
    del model, params, engine
    free_cuda()
    result["max_abs_err"] = serve_holds(rng, cfg, segments)
    return result


def phase_archs(rng) -> dict:
    """The six added architectures at full width: OLMo-1B training, HuBERT-
    XLarge's loss, gradients and encode, DeepSeek-7B serving whole, Yi-34B,
    Chameleon-34B and Arctic-480B serving with their depth cut (ARCH_SERVE_CUT).
    The kernels' counts are set to 0 before each run and read after it;
    returns each run's result by name."""
    runs = {"olmo_1b_train": arch_olmo_train(rng), "hubert_xlarge_loss": arch_hubert(rng),
            "deepseek_7b_serve": arch_serve_launcher(rng, "deepseek_7b")}
    for arch, layers in ARCH_SERVE_CUT.items():
        runs[f"{arch}_serve"] = arch_serve_cut(rng, arch, layers)
    return runs


def all_launches() -> dict:
    """The launch counts of K1-K6, K7 and the MLA kernels, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_attention as mk
    from repro_torch.kernels import ssd_scan as ssd

    return {**fa.LAUNCHES, **ssd.LAUNCHES, **mk.LAUNCHES}


def reset_all_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_attention as mk
    from repro_torch.kernels import ssd_scan as ssd

    fa.reset_launches()
    ssd.reset_launches()
    mk.reset_launches()


@contextlib.contextmanager
def counted_drops(sink: list):
    """Within the block, every MoE dispatch appends to ``sink`` its (token,
    expert) pairs, its capacity, the pairs of its own experts it dropped at
    capacity and those it kept (with expert parallelism a rank dispatches
    every pair and keeps only its own experts')."""
    from repro_torch.models import moe

    slots = moe.dispatch_slots

    def counted(ids, n_local, capacity, e_start=0):
        dest_e, dest_c, keep = slots(ids, n_local, capacity, e_start)
        local = ids.reshape(-1) - e_start
        own = (local >= 0) & (local < n_local)
        sink.append((ids.numel(), capacity, int((own & ~keep).sum()), int(keep.sum())))
        return dest_e, dest_c, keep

    moe.dispatch_slots = counted
    try:
        yield sink
    finally:
        moe.dispatch_slots = slots


def mixer_call(cfg, layer: int, p, h, positions, cache=None, index=None):
    """Layer ``layer``'s mixer alone, on the path the model gives it: a
    Mamba-2 block, or attention; a multi-token call with a cache is the
    prefill's (GQA: the slot-scatter route with one segment a row, row i into
    cache row i; MLA: the latent cache filled from ``index``)."""
    import torch

    from repro_torch.models.attention import apply_attention
    from repro_torch.models.ssm import apply_ssm_block

    if cfg.layer_kind(layer) == "ssm":
        return apply_ssm_block(p, h, cfg, cache)
    b, s = h.shape[:2]
    if cache is not None and s > 1 and cfg.attn_kind == "gqa":
        seg = torch.ones((b, s), dtype=torch.int32, device=h.device)
        rows = torch.arange(b, dtype=torch.int32, device=h.device)[:, None].expand(b, s)
        return apply_attention(p, h, cfg, positions, seg, cache, None, dest_slot=rows)
    return apply_attention(p, h, cfg, positions, None, cache, index)


def mixer_rail(model, params, layer: int, x, prompt: int) -> float:
    """Cache consistency of layer ``layer``'s mixer on its real input ``x``
    (B, prompt + RAIL_STEPS, d): the prefill of ``prompt`` tokens into a
    fresh cache and RAIL_STEPS one-token decode steps at a per-row frontier
    against one cache-free call on the whole sequence, equal at every
    decoded position within bf16's 2e-2 of the output's scale.  Returns the
    worst error's share of that allowance."""
    import torch

    from repro_torch.models.blocks import init_layer_cache
    from repro_torch.models.layers import apply_norm

    cfg = model.cfg
    b, total = x.shape[:2]
    p = params["layers"][layer]
    positions = torch.arange(total, dtype=torch.int32, device=x.device).expand(b, total)
    with torch.no_grad():
        h = apply_norm(p["norm_mixer"], x, cfg)
        full, _ = mixer_call(cfg, layer, p["mixer"], h, positions)
        cache = init_layer_cache(cfg, layer, b, total, model.dtype, model.device)
        _, cache = mixer_call(cfg, layer, p["mixer"], h[:, :prompt], positions[:, :prompt], cache, 0)
        outs = []
        for i in range(prompt, total):
            frontier = torch.full((b,), i, dtype=torch.int32, device=x.device)
            out, cache = mixer_call(cfg, layer, p["mixer"], h[:, i:i + 1], positions[:, i:i + 1], cache,
                                    frontier)
            outs.append(out)
    ours, ref = torch.cat(outs, dim=1).float(), full[:, prompt:].float()
    scale = ref.abs().max().item()
    err = (ours - ref).abs().max().item()
    kind = "ssm" if cfg.layer_kind(layer) == "ssm" else cfg.attn_kind
    check(math.isfinite(err) and err <= TOL["bfloat16"] * scale,
          f"{cfg.name} layer {layer} ({kind}) mixer: prefill {prompt} + {total - prompt} cached steps vs "
          f"the cache-free call: max_abs_err {err} > 2e-2 of the scale {scale}")
    print(f"[mla_hybrid] {cfg.name} layer {layer} ({kind}) mixer, {b} x ({prompt} prefill + "
          f"{total - prompt} cached steps) vs one cache-free call: max_abs_err {err:.4g} at the decoded "
          f"positions (scale {scale:.4g}; {err / (TOL['bfloat16'] * scale):.3f} of 2e-2 of it)")
    return err / (TOL["bfloat16"] * scale)


def whole_model_rail(model, params) -> float:
    """One prompt of RAIL_STEPS tokens and RAIL_STEPS ``decode_step``s
    against ``LM.forward`` on those 2 x RAIL_STEPS tokens: logits equal at
    positions RAIL_STEPS - 1 onward within 2e-2 of their scale.  With at most
    8 tokens in a call no expert exceeds its capacity of 8, so neither side
    drops a (token, expert) pair: asserted."""
    import torch

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (1, 2 * RAIL_STEPS), generator=gen, device="cuda")
    drops: list = []
    with counted_drops(drops), torch.no_grad():
        full = model.forward(params, {"tokens": tokens})[..., :cfg.vocab_size]
        logits, caches = model.prefill(params, tokens[:, :RAIL_STEPS], 2 * RAIL_STEPS)
        steps = [logits]
        for i in range(RAIL_STEPS, 2 * RAIL_STEPS):
            logits, caches = model.decode_step(params, caches, tokens[:, i:i + 1], i)
            steps.append(logits)
    ours, ref = torch.cat(steps, dim=1)[..., :cfg.vocab_size], full[:, RAIL_STEPS - 1:].float()
    scale = ref.abs().max().item()
    err = (ours - ref).abs().max().item()
    dropped = sum(d[2] for d in drops)
    check(dropped == 0, f"{cfg.name}: {dropped} pairs dropped with at most 8 tokens a call")
    check(math.isfinite(err) and err <= TOL["bfloat16"] * scale,
          f"{cfg.name}: prefill {RAIL_STEPS} + {RAIL_STEPS} decode_steps vs forward: max_abs_err {err} > "
          f"2e-2 of the scale {scale}")
    print(f"[mla_hybrid] {cfg.name} whole model: prefill {RAIL_STEPS} + {RAIL_STEPS} decode_steps vs "
          f"forward on {2 * RAIL_STEPS} tokens: max_abs_err {err:.4g} over positions {RAIL_STEPS - 1}.."
          f"{2 * RAIL_STEPS - 1} (scale {scale:.4g}; {err / (TOL['bfloat16'] * scale):.3f} of 2e-2 of it), "
          f"0 of the {len(drops)} MoE calls dropped a pair")
    return err / (TOL["bfloat16"] * scale)


def mla_hybrid_serve(model, params, prompt: int, rng) -> dict:
    """``LM.prefill`` of MLA_HYBRID_ROWS prompts of ``prompt`` tokens, then
    MLA_HYBRID_DECODE greedy ``decode_step``s; the kernels' counts set to 0
    before and read after each part; then the mixer rails on layer 0 (and,
    for a hybrid stack, on its attention layer) at the run's length."""
    import torch

    cfg = model.cfg
    vocab = cfg.vocab_size
    tokens = torch.from_numpy(rng.integers(1, vocab, (MLA_HYBRID_ROWS, prompt))).cuda()
    max_len = prompt + MLA_HYBRID_DECODE
    logits, caches = model.prefill(params, tokens[:, :64], 66)  # warm-up: cuBLAS, the allocator's pools
    model.decode_step(params, caches, logits[:, -1, :vocab].argmax(-1, keepdim=True), 64)
    del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    drops: list = []
    with counted_drops(drops):
        t = time.perf_counter()
        logits, caches = model.prefill(params, tokens, max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    prefill_launches = all_launches()
    check(bool(torch.isfinite(logits[..., :vocab]).all()), f"{cfg.name}: prefill logits not finite")
    first = logits[:, -1, :vocab].argmax(-1, keepdim=True)
    generated = [first]
    reset_all_launches()
    t = time.perf_counter()
    tok = first
    for i in range(MLA_HYBRID_DECODE):
        logits, caches = model.decode_step(params, caches, tok, prompt + i)
        tok = logits[:, -1, :vocab].argmax(-1, keepdim=True)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    decode_launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(logits[..., :vocab]).all()), f"{cfg.name}: decode logits not finite")
    n_gqa = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers)) * (cfg.attn_kind == "gqa")
    n_ssm = sum(cfg.layer_kind(l) == "ssm" for l in range(cfg.n_layers))
    want = {**dict.fromkeys(prefill_launches, 0), "segment_flash_attention_pruned": n_gqa, "ssd_scan": n_ssm}
    check(prefill_launches == want, f"{cfg.name} prefill launches {prefill_launches} != {want}")
    check(not any(decode_launches.values()), f"{cfg.name} decode launched kernels: {decode_launches}")
    moe_calls = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    print(f"[mla_hybrid] {cfg.name} serve: prefill {MLA_HYBRID_ROWS} x {prompt} {1e3 * prefill_s:.2f} ms "
          f"({MLA_HYBRID_ROWS * prompt / prefill_s:.0f} prompt tokens/s), decode {MLA_HYBRID_DECODE} steps "
          f"{1e3 * decode_s / MLA_HYBRID_DECODE:.3f} ms a step ({MLA_HYBRID_ROWS * MLA_HYBRID_DECODE / decode_s:.1f} "
          f"generated tokens/s), max_memory_allocated {peak / 2**30:.3f} GiB; launches: prefill "
          f"{prefill_launches}, decode none; MoE pairs dropped at capacity in the prefill: "
          f"{sum(d[2] for d in drops)} of {sum(d[0] for d in drops)} ({moe_calls} MoE layer(s), capacity "
          f"{drops[0][1] if drops else 0})")
    ids = torch.cat(generated, dim=1)
    check(bool(((ids >= 0) & (ids < vocab)).all()), f"{cfg.name}: generated ids outside the vocabulary")
    del logits, caches
    # The mixer rails at the run's length: the prompts and the first decoded tokens as the input.
    seq = torch.cat([tokens, ids[:, :RAIL_STEPS]], dim=1)
    with torch.no_grad():
        x = params["embed"][seq]
    shares = {0: mixer_rail(model, params, 0, x, prompt)}
    attn = [l for l in range(cfg.n_layers) if cfg.layer_kind(l) == "attn"]
    if cfg.uses_ssm and attn:
        from repro_torch.models.blocks import layer_forward

        positions = torch.arange(seq.shape[1], dtype=torch.int32, device="cuda").expand(*seq.shape)
        with torch.no_grad():
            for l in range(attn[0]):
                x = layer_forward(params["layers"][l], x, cfg, l, positions, None, None, None)[0]
        shares[attn[0]] = mixer_rail(model, params, attn[0], x, prompt)
    del x
    return dict(prefill_ms=1e3 * prefill_s, decode_ms=1e3 * decode_s / MLA_HYBRID_DECODE,
                tokens_per_s=MLA_HYBRID_ROWS * MLA_HYBRID_DECODE / decode_s, peak_gib=peak / 2**30,
                launches={k: prefill_launches[k] + decode_launches[k] for k in prefill_launches},
                prefill_drops=sum(d[2] for d in drops), mixer_rail_shares=shares)


def mla_hybrid_loss(model, params, rows: int, rng) -> dict:
    """One ``loss_sums`` with the gradients of the mean loss on a packed
    batch of ``rows`` x MLA_HYBRID_LEN tokens in 256-2048-token segments,
    under the trainer's ``remat="full"``: a first call on the dense grid
    (the warm-up; for a stack with GQA attention, the reference, its
    gradients held in host memory), then the timed call on the pruned grid,
    whose loss and every gradient must equal the reference bitwise."""
    import torch

    from repro_torch.train.optimizer import global_norm, tree_leaves

    cfg = model.cfg
    check(cfg.remat == "full", f"{cfg.name}: remat {cfg.remat}")
    seg_np, pos_np = long_segments(rng, rows, MLA_HYBRID_LEN)
    segments = torch.from_numpy(seg_np).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = dict(
        tokens=torch.randint(0, cfg.vocab_size, (rows, MLA_HYBRID_LEN), generator=gen, device="cuda"),
        positions=torch.from_numpy(pos_np).cuda(), segments=segments,
        labels=torch.randint(0, cfg.vocab_size, (rows, MLA_HYBRID_LEN), generator=gen, device="cuda"),
        loss_mask=(segments > 0).float(),
    )
    leaves = tree_leaves(params)

    def loss_and_grads(grid: str):
        model.cfg = dataclasses.replace(cfg, attn_grid=grid)
        try:
            loss_sum, count = model.loss_sums(params, batch)
            return (loss_sum / count).detach(), torch.autograd.grad(loss_sum / count, leaves)
        finally:
            model.cfg = cfg

    gqa = cfg.attn_kind == "gqa" and any(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers))
    ref_loss, ref_grads = loss_and_grads("dense")
    ref_grads = [g.cpu() for g in ref_grads] if gqa else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t = time.perf_counter()
    loss, grads = loss_and_grads("pruned")
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    gnorm = global_norm(grads).item()
    check(math.isfinite(loss.item()) and math.isfinite(gnorm), f"{cfg.name}: loss {loss} grad norm {gnorm}")
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers)) if gqa else 0
    n_mla = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers)) * (cfg.attn_kind == "mla")
    n_ssm = sum(cfg.layer_kind(l) == "ssm" for l in range(cfg.n_layers))
    want = {**dict.fromkeys(launches, 0), "segment_flash_attention_pruned": 2 * n_attn,
            "segment_flash_attention_bwd_pruned_dq": n_attn, "segment_flash_attention_bwd_pruned_dkv": n_attn,
            "ssd_scan": 2 * n_ssm, "mla_fwd": 2 * n_mla, "mla_bwd_dq": n_mla, "mla_bwd_dkv": n_mla}
    check(launches == want, f"{cfg.name} loss launches {launches} != {want}")
    bitwise = ""
    if gqa:
        same = torch.equal(loss, ref_loss) and all(torch.equal(g, r.to(g.device)) for g, r in zip(grads, ref_grads))
        check(same, f"{cfg.name}: the pruned and dense grids differ (loss {loss.item()} vs {ref_loss.item()})")
        bitwise = f"; on the dense grid the loss and all {len(grads)} gradients are bitwise equal"
    tokens = int((seg_np > 0).sum())
    print(f"[mla_hybrid] {cfg.name} loss: {rows} x {MLA_HYBRID_LEN} packed ({int(seg_np.max())} segments in a "
          f"row at most, {tokens} real tokens), loss {loss.item():.6f} grad_norm {gnorm:.6f}, loss+grads "
          f"{1e3 * step_s:.1f} ms ({tokens / step_s:.1f} tokens/s), max_memory_allocated {peak / 2**30:.3f} GiB, "
          f"launches {launches}{bitwise}")
    del grads, ref_grads, batch, leaves
    return dict(loss=loss.item(), grad_norm=gnorm, step_ms=1e3 * step_s, peak_gib=peak / 2**30,
                launches=launches, segments=seg_np)


def phase_mla_hybrid(rng) -> dict:
    """DeepSeek-V3 (MLA, the 3-layer dense prefix, 256 experts with a shared
    one) and Jamba (the hybrid period: a Mamba-2 layer with the 16-expert
    MoE, an attention layer with the dense MLP) at full width with their
    depth cut (MLA_HYBRID), random weights from seed 0, bf16, one after the
    other: per-request serving with the mixer rails, the whole-model cache
    rail, one loss with its gradients.  Then K1-K6 held at Jamba's loss
    segments and prefill rows with its 64/8 heads, K7 timed and held at its
    prefill's (8, 2048) with 256 heads and held at its loss's (2, 4096).
    Returns each run's results."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    runs: dict = {}
    for arch, (cut, prompt, rows) in MLA_HYBRID.items():
        cfg = dataclasses.replace(get_config(arch), **cut)
        t0 = time.perf_counter()
        model = LM(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        kinds = "".join("A" if cfg.layer_kind(l) == "attn" else "M" for l in range(cfg.n_layers))
        print(f"[mla_hybrid] {cfg.name}: {cfg.n_layers} layers (depth cut from {get_config(arch).n_layers}; "
              f"mixers {kinds}, MoE at {[l for l in range(cfg.n_layers) if cfg.layer_is_moe(l)]}) d_model "
              f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} attention {cfg.attn_kind} experts "
              f"{cfg.n_experts} top-{cfg.top_k} (+{cfg.n_shared_experts} shared) "
              f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params {cfg.dtype}, init "
              f"{time.perf_counter() - t0:.1f}s")
        serve = mla_hybrid_serve(model, params, prompt, rng)
        whole = whole_model_rail(model, params)
        loss = mla_hybrid_loss(model, params, rows, rng)
        runs[arch] = dict(serve=serve, whole_model_rail_share=whole, loss=loss, prompt=prompt)
        del model, params
        free_cuda()
    jamba = MLA_HYBRID["jamba_1_5_large"]
    cfg = dataclasses.replace(get_config("jamba_1_5_large"), **jamba[0])
    widths = dict(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
    errs = hold_kernels(rng, f"{cfg.name} loss", runs["jamba_1_5_large"]["loss"]["segments"],
                        exact_tol=JAMBA_LOSS_EXACT_TOL, **widths)
    prefill_rows = np.ones((MLA_HYBRID_ROWS, jamba[1]), np.int32)
    prefill_errs = hold_kernels(rng, f"{cfg.name} prefill", prefill_rows, backward=False, **widths)
    errs = {name: max(err, prefill_errs.get(name, 0.0)) for name, err in errs.items()}
    ssd_row = ssd_time(rng, MLA_HYBRID_ROWS, jamba[1], cfg.n_ssm_heads)
    # the loss's shape: rows x MLA_HYBRID_LEN, 16 chunks, grid nc*H = 4096
    _, ssd_row["loss_shape_max_abs_err"] = hold_ssd(rng, jamba[2], MLA_HYBRID_LEN, cfg.n_ssm_heads)
    torch.cuda.empty_cache()
    launches = {f"{arch}_{part}": runs[arch][part]["launches"] for arch in runs for part in ("serve", "loss")}
    return dict(runs=runs, launches=launches, max_abs_err=errs, ssd=ssd_row)


# -- mesh: the sharded flash check, remat="dots", the dry run on the card's torch ----------


def mesh_inputs(train_seg):
    """Qwen3-0.6B's attention widths on the first training step's rows:
    fp32 normals on the CPU from seed 13, and the step's segment ids."""
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(13)
    b, s = train_seg.shape
    q, k, v = (torch.randn((b, s, n, D_HEAD), generator=g) for n in (HEADS, KV_HEADS, KV_HEADS))
    return q, k, v, torch.from_numpy(np.ascontiguousarray(train_seg, dtype=np.int32))


def mesh_reference(inputs, grid: str, dtype: str) -> dict:
    """The single-process call on every row (out, dq, dk, dv), the blocks
    ``validate_flash_sharded`` takes."""
    import torch

    from repro_torch.kernels.ops import flash_attention

    q, k, v = (t.to("cuda", getattr(torch, dtype)).contiguous().requires_grad_() for t in inputs[:3])
    out = flash_attention(q, k, v, inputs[3].cuda(), True, 128, 128, grid)
    grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    return {"out": out.detach(), **dict(zip(("dq", "dk", "dv"), grads))}


def mesh_compare(tensors: dict, ref: dict, rows: list, dtype: str) -> dict:
    """Per tensor: bitwise equal to the reference's rows, or else the worst
    error and whether it lies within the kernel's tolerance tol·(1 + |ref|)."""
    import torch

    out = {}
    for name, t in tensors.items():
        want = ref[name][rows[0]:rows[1]]
        t = t.to(want.device)
        err = float((t.float() - want.float()).abs().max())
        ok = bool(((t.float() - want.float()).abs() <= TOL[dtype] * (1 + want.float().abs())).all())
        out[name] = dict(equal=bool(torch.equal(t, want)), max_abs_err=err, within_tol=ok)
    return out


def mesh_sharded(mesh, inputs, rows_per_shard: int) -> dict:
    """``validate_flash_sharded`` in both dtypes and grids on this rank (a
    warm-up call, then the measured one), each held against the
    single-process call made in this process.  Returns per case the record
    (without tensors), the comparison and the sha256 of the rank's
    tensors."""
    import torch

    from repro_torch.launch.flash_dryrun import validate_flash_sharded

    cases = {}
    for dtype in ("bfloat16", "float32"):
        for grid in ("dense", "pruned"):
            kw = dict(rows_per_shard=rows_per_shard, seq=inputs[0].shape[1], heads=HEADS,
                      kv_heads=KV_HEADS, head_dim=D_HEAD, dtype=dtype, inputs=inputs)
            validate_flash_sharded(mesh, grid, **kw)
            rec = validate_flash_sharded(mesh, grid, keep=True, **kw)
            check(rec["status"] == "ok", f"[mesh] {dtype} {grid}: {rec.get('traceback')}")
            tensors = rec.pop("tensors")
            ref = mesh_reference(inputs, grid, dtype)
            rec["compare"] = mesh_compare(tensors, ref, rec["rows"], dtype)
            rec["sha256"] = {n: hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes()).hexdigest()[:16] for n, t in tensors.items()}
            cases[f"{dtype}/{grid}"] = rec
            del tensors, ref
    return cases


def mesh_rank_main(rank: int, world: int, init_file: str, queue, train_seg) -> None:
    """One gloo rank of the sharded flash check, spawned; both ranks share
    the card.  Puts its cases (or its error) on ``queue``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        try:
            inputs = mesh_inputs(train_seg)
            out["cases"] = mesh_sharded(make_host_mesh(), inputs, inputs[0].shape[0] // world)
        finally:
            dist.destroy_process_group()
    except Exception as exc:  # reported to the parent, which fails the phase
        import traceback

        out["error"] = f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"
    queue.put(out)


def mesh_held(tag: str, cases: dict) -> None:
    for case, rec in cases.items():
        for name, cmp in rec["compare"].items():
            if not cmp["equal"]:
                print(f"{tag} {case} {name}: not bitwise equal to the single-process call, worst error "
                      f"{cmp['max_abs_err']:.3e} (within the kernel's tolerance: {cmp['within_tol']})")
            check(cmp["equal"] or cmp["within_tol"], f"{tag} {case} {name}: {cmp}")
        grid = case.split("/")[1]
        want = {n: int(KERNELS[n][2] == grid) for n in KERNELS}
        check(rec["launches"] == want, f"{tag} {case}: launches {rec['launches']} != {want}")


def mesh_flash(train_seg) -> dict:
    """(a) The sharded flash check at world 1 over NCCL in this process and
    at world 2 over gloo in two spawned ranks."""
    import tempfile
    from queue import Empty

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.launch.mesh import make_host_mesh

    tag = "[mesh]"
    inputs = mesh_inputs(train_seg)
    rows = inputs[0].shape[0]
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    try:
        dist.init_process_group("nccl", init_method=f"file://{work / 'nccl'}", rank=0, world_size=1)
        try:
            nccl = mesh_sharded(make_host_mesh(), inputs, rows)
        finally:
            dist.destroy_process_group()
        mesh_held(f"{tag} world 1 over NCCL", nccl)
        ctx = tmp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=mesh_rank_main, args=(r, 2, str(work / "gloo"), queue, train_seg))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            ranks = []
            while len(ranks) < len(procs):
                try:
                    ranks.append(queue.get(timeout=5))
                except Empty:
                    check(all(p.is_alive() for p in procs),
                          f"{tag} a rank exited without a result: {[p.exitcode for p in procs]}")
            ranks.sort(key=lambda r: r["rank"])
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    for r in ranks:
        check("error" not in r, f"{tag} rank {r['rank']} failed: {r.get('error')}")
        mesh_held(f"{tag} world 2 over gloo, rank {r['rank']}", r["cases"])
    for case, rec in nccl.items():
        losses = [r["cases"][case]["loss"] for r in ranks]
        check(losses[0] == losses[1], f"{tag} {case}: the ranks' summed losses differ: {losses}")
        check(abs(losses[0] - rec["loss"]) <= 1e-5 * abs(rec["loss"]),
              f"{tag} {case}: world 2 loss {losses[0]} vs world 1 {rec['loss']}")
        print(f"{tag} {case} (2 x {rec['seq']}, {HEADS}/{KV_HEADS} heads, d_head {D_HEAD}): world 1 NCCL "
              f"{rec['run_s'] * 1e3:.3f} ms, loss {rec['loss']:.6e}, bitwise "
              f"{all(c['equal'] for c in rec['compare'].values())}, launches "
              f"{ {n: c for n, c in rec['launches'].items() if c} }; world 2 gloo "
              + "; ".join(f"rank {r['rank']} rows {r['cases'][case]['rows']} "
                          f"{r['cases'][case]['run_s'] * 1e3:.3f} ms, bitwise "
                          f"{all(c['equal'] for c in r['cases'][case]['compare'].values())}, sha256 "
                          f"{r['cases'][case]['sha256']['out']}, launches "
                          f"{ {n: c for n, c in r['cases'][case]['launches'].items() if c} }"
                          for r in ranks))
    launches = {n: {"nccl_world1": sum(rec["launches"][n] for rec in nccl.values()),
                    "gloo_world2": [sum(rec["launches"][n] for rec in r["cases"].values()) for r in ranks]}
                for n in KERNELS}
    return dict(launches=launches, nccl=nccl, gloo=[r["cases"] for r in ranks])


def mesh_remat() -> dict:
    """(b) Full-width Qwen3-0.6B packed training, MESH_TRAIN_STEPS steps
    each under remat "full", "dots" and "none" on the same batches, from
    seed-0 weights: the loss and grad_norm under "dots" bitwise equal to
    "full"'s, "none" within MESH_REMAT_RTOL; K4 2 x 28 a step under "full"
    and "dots", 28 under "none" (the kernel is not a product, so it is
    recomputed); peak memory and step ms per mode."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import LM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import assemble_model_batch, make_train_step

    tag = "[mesh]"
    trainer, loader = train_launcher.build(train_launcher.parser().parse_args(TRAIN_ARGS))
    batches = []
    for loader_step in loader.epoch(0):
        batches.append(assemble_model_batch(loader_step, loader.layout, trainer.model.device))
        if len(batches) == MESH_TRAIN_STEPS:
            break
    base = dataclasses.replace(trainer.model.cfg, attn_impl="flash", attn_grid="pruned")
    opt_cfg, n_layers = trainer.opt_cfg, base.n_layers
    del trainer
    free_cuda()
    runs = {}
    for mode in ("full", "dots", "none"):
        model = LM(dataclasses.replace(base, remat=mode))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        step = make_train_step(model, opt_cfg)
        rec = {"loss": [], "grad_norm": [], "step_ms": [], "k4": [], "launches": dict.fromkeys(KERNELS, 0)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for batch in batches:
            fa.reset_launches()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t) * 1e3)
            rec["k4"].append(fa.LAUNCHES["segment_flash_attention_pruned"])
            rec["launches"] = {n: rec["launches"][n] + fa.LAUNCHES[n] for n in KERNELS}
            rec["loss"].append(float(metrics["loss"]))
            rec["grad_norm"].append(float(metrics["grad_norm"]))
            check(all(math.isfinite(x) for x in (rec["loss"][-1], rec["grad_norm"][-1])),
                  f"{tag} remat={mode}: loss {rec['loss'][-1]} grad_norm {rec['grad_norm'][-1]}")
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["rows"] = list(batches[0]["tokens"].shape)
        runs[mode] = rec
        print(f"{tag} remat={mode}: {MESH_TRAIN_STEPS} steps of {rec['rows']}, losses {rec['loss']}, "
              f"grad_norm {rec['grad_norm']}, step ms {[round(x, 3) for x in rec['step_ms']]}, peak "
              f"{rec['peak_gib']:.3f} GiB, K4 per step {rec['k4']}")
        del model, params, state, step
        free_cuda()
    for mode, want in (("full", 2 * n_layers), ("dots", 2 * n_layers), ("none", n_layers)):
        check(runs[mode]["k4"] == [want] * MESH_TRAIN_STEPS,
              f"{tag} remat={mode}: K4 per step {runs[mode]['k4']} != {want}")
    check(runs["dots"]["loss"] == runs["full"]["loss"]
          and runs["dots"]["grad_norm"] == runs["full"]["grad_norm"],
          f"{tag} remat=dots is not bitwise remat=full: {runs['dots']} vs {runs['full']}")
    for key in ("loss", "grad_norm"):
        for a, b in zip(runs["none"][key], runs["full"][key]):
            check(abs(a - b) <= MESH_REMAT_RTOL * abs(b), f"{tag} remat=none {key} {a} vs full {b}")
    print(f"{tag} remat=dots: loss and grad_norm bitwise equal to remat=full over {MESH_TRAIN_STEPS} steps; "
          f"remat=none within {MESH_REMAT_RTOL}")
    return runs


def mesh_dryrun() -> dict:
    """(c) ``python -m repro_torch.launch.dryrun --mesh both`` for each of
    MESH_CELLS, in parallel subprocesses on the card's torch (the fake
    process group and the meta device); each record's bytes per device,
    whether it fits and its dominant roofline term."""
    tag = "[mesh]"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for cell in MESH_CELLS:
        arch, shape = cell.split(":")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--mesh", "both", "--force"]
        procs.append((cell, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    records = {}
    for cell, proc in procs:
        try:
            out, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        check(proc.returncode == 0, f"{tag} dryrun {cell} exited {proc.returncode}:\n{out[-3000:]}")
        arch, shape = cell.split(":")
        for mesh in ("single", "multi"):
            rec = json.loads((ROOT / "artifacts" / "dryrun_torch" / f"{arch}__{shape}__{mesh}.json").read_text())
            check(rec["status"] == "ok", f"{tag} dryrun {cell} {mesh}: {rec.get('error')}")
            parts = {k: round(v / 2**30, 3) for k, v in rec["bytes_parts"].items()}
            print(f"{tag} dryrun {arch} x {shape} x {mesh} ({rec['chips']} H100s): "
                  f"{rec['bytes_per_device'] / 2**30:.3f} GiB/device {parts}, fits 80 GiB {rec['fits']}, "
                  f"dominant {rec['roofline']['dominant']}, terms s compute {rec['roofline']['compute_s']:.4e} "
                  f"memory {rec['roofline']['memory_s']:.4e} (upper) collective "
                  f"{rec['roofline']['collective_s']:.4e}, run {rec['run_s']}s")
            records[f"{cell}:{mesh}"] = {k: rec[k] for k in ("bytes_per_device", "bytes_parts", "fits",
                                                             "run_s")}
            records[f"{cell}:{mesh}"]["dominant"] = rec["roofline"]["dominant"]
    return records


def phase_mesh(train_seg) -> dict:
    """The mesh slice on the card: (a) the sharded flash check, (b)
    remat="dots" training, (c) the dry run under the card's torch."""
    import torch

    print(f"[mesh] torch {torch.__version__}")
    flash = mesh_flash(train_seg)
    remat = mesh_remat()
    dry = mesh_dryrun()
    launches = flash["launches"]
    for n in KERNELS:
        launches[n]["remat_dots"] = remat["dots"]["launches"][n]
    return dict(launches=launches, remat=remat, dryrun=dry)


# -- ep: the MoE's expert parallelism on full-width Arctic, and the examples ---------------


def ep_inputs(cfg) -> dict:
    """The serving trace's first EP_REQUESTS requests and one packed row of
    EP_LEN tokens in 256-2048-token segments with seeded tokens and labels,
    as numpy (the ranks get the same arrays)."""
    import numpy as np

    from repro_torch.serve import synth_request_trace

    trace = synth_request_trace(ARCH_SERVE_REQUESTS, vocab=cfg.vocab_size, prompt_min=8, prompt_max=96,
                                new_min=2, new_max=48, seed=0)[:EP_REQUESTS]
    seg, pos = long_segments(np.random.default_rng(14), 1, EP_LEN)
    g = np.random.default_rng(15)
    batch = dict(tokens=g.integers(0, cfg.vocab_size, (1, EP_LEN)), positions=pos, segments=seg,
                 labels=g.integers(0, cfg.vocab_size, (1, EP_LEN)), loss_mask=(seg > 0).astype(np.float32))
    return dict(trace=trace, batch=batch)


def ep_run(model, params, inputs: dict, tag: str) -> dict:
    """On ``model``'s mesh: the engine serving the inputs' requests, then one
    ``loss_sums`` with the gradients of the mean loss on the packed row
    (remat "full": K4 twice, K5 and K6 once a layer), the kernels' counts
    set to 0 before each and read after.  Returns the ids, the first
    prefill's picked logits (on the host), the loss, the gradients (on the
    card, in ``tree_leaves`` order), the (token, expert) pairs kept and
    dropped, the launches, times and the peak."""
    import torch

    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig
    from repro_torch.train.optimizer import tree_leaves

    cfg = model.cfg
    config = ServeConfig(num_slots=8, max_len=256, l_max=1024, lookahead=32)
    warm = ContinuousBatchingEngine(model, params, config, mesh=model.mesh)  # cuBLAS, the allocator
    warm.submit(inputs["trace"][0][0], 2)
    warm.run()
    del warm
    engine = ContinuousBatchingEngine(model, params, config, mesh=model.mesh)
    picked, segments = [], []
    record_prefill(engine, sink=picked, segments=segments)
    rids = [engine.submit(p, n) for p, n in inputs["trace"]]
    drops: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with counted_drops(drops):
        t = time.perf_counter()
        outputs = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    serve_launches = all_launches()
    st = engine.stats
    check(st.finished == len(rids), f"{tag}: {st.finished}/{len(rids)} requests finished")
    want = {**dict.fromkeys(serve_launches, 0), "segment_flash_attention_pruned": st.prefill_calls * cfg.n_layers}
    check(serve_launches == want, f"{tag} serve launches {serve_launches} != {want}")
    first_calls = drops[:model.dispatch_chunks]
    rec = dict(ids=[list(map(int, outputs[r])) for r in rids], picked=picked[0].float().cpu().numpy(),
               serve_launches=serve_launches, tick_ms=1e3 * wall / st.ticks, ticks=st.ticks,
               prefill_calls=st.prefill_calls, serve_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               first_prefill_pairs=(sum(d[3] for d in first_calls), sum(d[2] for d in first_calls)),
               serve_pairs=(sum(d[3] for d in drops), sum(d[2] for d in drops)), segments=segments)
    del engine, picked
    batch = {k: torch.from_numpy(v).cuda() for k, v in inputs["batch"].items()}
    leaves = tree_leaves(params)
    # Warm-up on the first 512 tokens: the first checkpointed backward of a
    # process imports torch._dynamo (~10 s).
    loss_sum, count = model.loss_sums(params, {k: v[:, :512] for k, v in batch.items()})
    torch.autograd.grad(loss_sum / count, leaves)
    del loss_sum, count
    free_cuda()
    drops = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with counted_drops(drops):
        t = time.perf_counter()
        loss_sum, count = model.loss_sums(params, batch)
        loss = loss_sum / count
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t
    loss_launches = all_launches()
    n = cfg.n_layers
    want = {**dict.fromkeys(loss_launches, 0), "segment_flash_attention_pruned": 2 * n,
            "segment_flash_attention_bwd_pruned_dq": n, "segment_flash_attention_bwd_pruned_dkv": n}
    check(loss_launches == want, f"{tag} loss launches {loss_launches} != {want}")
    # A sum per gradient: no temporary the size of a 4.5-8.9 GB slab.
    check(math.isfinite(loss.item()) and all(math.isfinite(g.sum(dtype=torch.float32).item()) for g in grads),
          f"{tag}: loss {loss.item()} or a gradient not finite")
    rec.update(loss=loss.item(), grads=list(grads), loss_launches=loss_launches, loss_ms=1e3 * loss_s,
               loss_pairs=(sum(d[3] for d in drops), sum(d[2] for d in drops)),
               loss_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"{tag}: {len(rids)} requests, {st.ticks} ticks of {rec['tick_ms']:.2f} ms, {st.prefill_calls} "
          f"prefill calls, peak {rec['serve_peak_gib']:.3f} GiB, launches {serve_launches}; (token, expert) "
          f"pairs kept/dropped: first prefill {rec['first_prefill_pairs']}, the run {rec['serve_pairs']}; "
          f"loss_sums + gradients on 1 x {EP_LEN}: loss {rec['loss']:.6f}, {rec['loss_ms']:.1f} ms, peak "
          f"{rec['loss_peak_gib']:.3f} GiB, launches {loss_launches}, pairs kept/dropped {rec['loss_pairs']}")
    return rec


def ep_share(ours, ref, tol: float) -> tuple:
    """(worst |ours - ref|, its share of the allowance tol·(1 + |ref|)),
    taken a slice of the leading dimension at a time; ``ref`` may lie on the
    host."""
    import torch

    err = share = 0.0
    step = max(1, (1 << 25) // max(1, ours[0].numel() if ours.dim() else 1))
    for i in range(0, max(1, ours.shape[0] if ours.dim() else 1), step):
        o = ours[i:i + step].float() if ours.dim() else ours.float()
        r = (ref[i:i + step] if ref.dim() else ref).to(o.device, torch.float32)
        d = (o - r).abs()
        err = max(err, d.max().item())
        share = max(share, (d / (tol * (1 + r.abs()))).max().item())
    return err, share


def ep_rank_main(rank: int, world: int, init_file: str, queue, proceed, shard: dict, inputs: dict, cfg) -> None:
    """One gloo rank of the ep phase, spawned; both ranks share the card and
    the parent's weights (``shard``, this rank's views of them, arrive by
    CUDA IPC).  For each of EP_CHUNKS: ``LM(cfg, mesh, dispatch_chunks)``
    on the shard, ``ep_run``, the record on ``queue`` (its gradients stay
    on the card, read by the parent), then wait until the parent has
    compared them."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_host_mesh(world)
            for i, chunks in enumerate(EP_CHUNKS):
                model = LM(cfg, mesh=mesh, dispatch_chunks=chunks)
                params = model.load_params(shard)
                rec = ep_run(model, params, inputs, f"[ep] world {world} over gloo, rank {rank}, "
                                                    f"dispatch_chunks {chunks}")
                free_cuda()  # hand the cached blocks back: the parent compares on the same card
                queue.put({"rank": rank, "chunks": chunks, **rec})
                proceed[i].wait(600)
                del rec, params, model
                free_cuda()
        finally:
            dist.destroy_process_group()
    except BaseException as exc:  # reported to the parent, which fails the phase
        import traceback

        queue.put({"rank": rank, "error": f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"})


def ep_collect(queue, procs, n: int, tag: str) -> list:
    from queue import Empty

    out = []
    while len(out) < n:
        try:
            out.append(queue.get(timeout=5))
        except Empty:
            check(all(p.is_alive() for p in procs),
                  f"{tag}: a rank exited without a result: exit codes {[p.exitcode for p in procs]}")
    for r in out:
        check("error" not in r, f"{tag} rank {r['rank']} failed: {r.get('error')}")
    return sorted(out, key=lambda r: r["rank"])


def phase_ep(rng) -> dict:
    """Expert parallelism on full-width Arctic-480B cut to EP_LAYERS layer,
    bf16, weights from seed 0 made once here: the engine serving the
    trace's first EP_REQUESTS requests and one loss with its gradients, at
    world 1 over NCCL (the single-device branch) in this process, then at
    world EP_WORLD over gloo in spawned ranks sharing the card and this
    process's weights (each holds its shard: 64 experts and half the dense
    residual's width), dispatch_chunks 1 and then 2.  World 2 with one
    chunk must keep and drop the pairs world 1 does, and its logits, loss
    and every gradient must lie within the bf16 allowance of world 1's.
    K1-K6 are then held at the loss's segments and K1/K4 at the prefill
    buckets with Arctic's 56/8 heads; then the four examples run on the card.
    Returns the launches per run and the kernels' errors."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import moe_shard
    from repro_torch.models import LM
    from repro_torch.train.optimizer import tree_leaves

    tag, tol = "[ep]", TOL["bfloat16"]
    cfg = dataclasses.replace(get_config(EP_ARCH), n_layers=EP_LAYERS)
    inputs = ep_inputs(cfg)
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    slab = sum(params["layers"][0]["moe"][k].numel() for k in ("w_in", "w_gate", "w_out")) * 2
    print(f"{tag} {cfg.name}: {cfg.n_layers} layer (depth cut from {get_config(EP_ARCH).n_layers}) d_model "
          f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} experts {cfg.n_experts} top-{cfg.top_k} moe_d_ff "
          f"{cfg.moe_d_ff} dense residual d_ff {cfg.d_ff}, {sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f}B "
          f"params {cfg.dtype} ({slab / 1e9:.2f} GB of expert slabs), init {time.perf_counter() - t0:.1f}s")
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="ep-", dir=ROOT / "build"))
    runs: dict = {}
    try:
        dist.init_process_group("nccl", init_method=f"file://{work / 'nccl'}", rank=0, world_size=1)
        try:
            model = LM(cfg, mesh=make_host_mesh(1))
            one = ep_run(model, model.load_params(params), inputs, f"{tag} world 1 over NCCL")
        finally:
            dist.destroy_process_group()
        t = time.perf_counter()
        ref_tree = _grad_tree(params, [g.cpu() for g in one.pop("grads")])
        del model
        free_cuda()
        print(f"{tag} world 1's gradients moved to the host in {time.perf_counter() - t:.1f}s")
        runs["world1"] = one

        ctx = tmp.get_context("spawn")
        queue, proceed = ctx.Queue(), [ctx.Event() for _ in EP_CHUNKS]
        shared = _grad_tree(params, [t.detach() for t in tree_leaves(params)])  # leaves IPC can send
        procs = [ctx.Process(target=ep_rank_main, args=(r, EP_WORLD, str(work / "gloo"), queue, proceed,
                                                        moe_shard(shared, cfg, EP_WORLD, r), inputs, cfg))
                 for r in range(EP_WORLD)]
        for p in procs:
            p.start()
        try:
            for i, chunks in enumerate(EP_CHUNKS):
                recs = ep_collect(queue, procs, EP_WORLD, tag)
                for rec in recs:
                    name = f"world {EP_WORLD} rank {rec['rank']} dispatch_chunks {chunks}"
                    grads = rec.pop("grads")
                    if chunks == 1:
                        want = tree_leaves(moe_shard(ref_tree, cfg, EP_WORLD, rec["rank"]))
                        shares = {"logits": ep_share(torch.from_numpy(rec["picked"]),
                                                     torch.from_numpy(one["picked"]), tol),
                                  "loss": ep_share(torch.tensor(rec["loss"]), torch.tensor(one["loss"]), tol)}
                        grad_worst = max((ep_share(g, w, tol) for g, w in zip(grads, want)), key=lambda e: e[1])
                        shares["gradients"] = grad_worst
                        for key, (err, share) in shares.items():
                            check(share <= 1.0, f"{tag} {name}: {key} worst error {err:.3e} is {share:.3f} of "
                                                f"the bf16 allowance against world 1")
                        rec["shares"] = {k: v[1] for k, v in shares.items()}
                        rec["max_abs_err"] = {k: v[0] for k, v in shares.items()}
                        moved = [i for i, (a, b) in enumerate(zip(rec["ids"], one["ids"])) if a != b]
                        print(f"{tag} {name} against world 1: worst error / share of the bf16 allowance: "
                              + ", ".join(f"{k} {e:.3e} / {sh:.4f}" for k, (e, sh) in shares.items())
                              + f"; generated ids equal in {len(rec['ids']) - len(moved)} of {len(rec['ids'])} "
                                f"requests" + (f" (request {moved[0]} first differs at token "
                                               f"{_first_diff(rec['ids'][moved[0]], one['ids'][moved[0]])})"
                                               if moved else ""))
                    else:
                        print(f"{tag} {name}: loss {rec['loss']:.6f} (world 1, one dispatch: {one['loss']:.6f}), "
                              f"every gradient finite")
                    del grads
                    rec.pop("segments")
                    runs[f"world{EP_WORLD}_chunks{chunks}_rank{rec['rank']}"] = rec
                if chunks == 1:
                    ep_pairs_equal(one, recs, tag)
                torch.cuda.synchronize()
                proceed[i].set()
        except BaseException:
            for p in procs:  # the ranks wait for the parent: stop them now
                p.kill()
            raise
        finally:
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
        check(all(p.exitcode == 0 for p in procs), f"{tag} rank exit codes {[p.exitcode for p in procs]}")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    del params, shared, ref_tree
    free_cuda()
    widths = dict(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.d_head)
    errs = hold_kernels(rng, f"{tag} {cfg.name} loss", inputs["batch"]["segments"], **widths)
    prefill_errs = serve_holds(rng, cfg, one.pop("segments"))
    errs = {name: max(err, prefill_errs.get(name, 0.0)) for name, err in errs.items()}
    examples = ep_examples()
    launches = {run: {**rec["serve_launches"]} for run, rec in runs.items()}
    loss_launches = {run: rec["loss_launches"] for run, rec in runs.items()}
    return dict(runs=runs, launches=launches, loss_launches=loss_launches, max_abs_err=errs, examples=examples)


def _grad_tree(params: dict, grads: list) -> dict:
    """``grads`` (in ``tree_leaves`` order) in the layout of ``params``: a
    gradient tree, or with ``params``' own leaves detached, a tree that
    carries no autograd state."""
    from repro_torch.train.optimizer import tree_leaves

    by_id = {id(t): g for t, g in zip(tree_leaves(params), grads)}

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return by_id[id(tree)]

    return walk(params)


def _first_diff(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def ep_pairs_equal(one: dict, recs: list, tag: str) -> None:
    """The pairs the ranks keep sum to world 1's, and so do those they drop
    at capacity: in the first prefill and the loss always, over the whole
    serving run when the generated ids are equal (they decide the decode
    steps' tokens)."""
    keys = ["first_prefill_pairs", "loss_pairs"]
    if all(r["ids"] == one["ids"] for r in recs):
        keys.append("serve_pairs")
    for key in keys:
        summed = tuple(sum(r[key][i] for r in recs) for i in range(2))
        check(summed == tuple(one[key]), f"{tag} {key}: the ranks keep/drop {summed}, world 1 {one[key]}")
    print(f"{tag} (token, expert) pairs kept and dropped, summed over the ranks, equal world 1's in "
          f"{', '.join(keys)}: " + ", ".join(f"{k} {tuple(one[k])}" for k in keys))


def ep_examples() -> dict:
    """The four examples' card runs, side by side, each in a process of its
    own (``odb_vs_standard_torch.py`` runs no model: the schedules and the
    paper's cost model); prints each one's tail and returns its seconds."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t = time.perf_counter()
    procs = {" ".join(args): subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for args in EP_EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[name] = time.perf_counter() - t
            for line in stdout.strip().splitlines()[-8:]:
                print(f"[ep] {name}: {line}")
            check(proc.returncode == 0, f"[ep] {name} exited {proc.returncode}: {stderr[-3000:]}")
            print(f"[ep] {name}: done {out[name]:.1f}s after the examples started")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


def ssd_work(b, s, h=24, p=64, n=128, chunk=256, elem=2):
    """(FLOPs, bytes) of the least work of one K7 call with the final state:
    C.B^T once per (b, chunk) and, per (b, h, chunk), W.x over the causal
    pairs j <= i, C.state and the state update; x, adt, dt, B, C read once,
    y and the fp32 final state written once."""
    nc, pairs = s // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * (b * nc * pairs * n + b * h * nc * (pairs * p + 2 * chunk * p * n))
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * n) + 4 * (2 * b * s * h + b * h * p * n)
    return flops, nbytes


def device_launches(call, calls: int = 10) -> tuple:
    """The device launches behind calls of ``call`` (K7, the AdamW kernels)
    under ``torch.profiler``, after two warm-up calls under the same
    profiler that it does not record: the kernel launches per call, counted on the host (``cudaLaunchKernel``,
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


def hold_ssd(rng, b: int, s: int, h: int = 24) -> tuple:
    """K7 and its plain version at (b, s, h, 64, 128, chunk 256) in bf16, as
    the model calls it (strided views, no initial state, final state out):
    y and the final state held against each other at the bf16 tolerance.
    Returns the inputs and y's max abs error."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    args, _, _ = ssd_case(rng, b, s, h, 64, 128, torch.bfloat16, strided=True)
    y, final = ssd.ssd_scan(*args, chunk=256, return_final_state=True)
    ry, rfinal = ssd_chunked_ref(*args, 256)
    torch.cuda.synchronize()
    tol = SSD_TOL["bfloat16"]
    err = (y.float() - ry.float()).abs().max().item()
    serr = (final - rfinal).abs().max().item()
    check(torch.allclose(y.float(), ry.float(), **tol) and torch.allclose(final, rfinal, **tol),
          f"ssd_scan vs plain at ({b}, {s}, {h}) bf16 strided: y err {err}, state err {serr}")
    print(f"[ssd] ssd_scan ({b}, {s}, {h}, 64, 128, 256) bfloat16 decay 1.0 init=zero strided: "
          f"max_abs_err y {err:.3g} (max |y| {ry.float().abs().max().item():.3g}; "
          f"{allowance_share(y, ry, tol):.3f} of the allowance) state {serr:.3g} "
          f"(max |state| {rfinal.abs().max().item():.3g}; {allowance_share(final, rfinal, tol):.3f}) "
          f"(atol {tol['atol']}, rtol {tol['rtol']})")
    return args, err


def ssd_time(rng, b: int, s: int, h: int = 24) -> dict:
    """K7 held against its plain version at (b, s, h, 64, 128, chunk 256)
    (``hold_ssd``), the device launches of one call counted under the
    profiler, then each timed; returns the row of the ``kernels`` line."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref

    args, err = hold_ssd(rng, b, s, h)
    call = lambda: ssd.ssd_scan(*args, chunk=256, return_final_state=True)  # noqa: E731
    per_call, kernels = device_launches(call)
    check(per_call == SSD_BF16_KERNELS and len(kernels) == SSD_BF16_KERNELS,
          f"a bf16 K7 call must launch {SSD_BF16_KERNELS} device kernels: the profiler "
          f"counted {per_call} launches per call, of the kernels {sorted(kernels)}")
    for kname, (n, ms) in kernels.items():
        print(f"[times] ssd_scan B={b} S={s} H={h}: device kernel {kname.split('(')[0]} "
              f"{ms:.4f} ms per launch ({n:g} launches recorded on the device per call; profiled)")
    # The wrapper's scratch: the peak allocated during one call, less what
    # the call returns.
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
    flops, nbytes = ssd_work(b, s, h)
    bound_by = "operations" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES else "bytes"
    bound_ms = 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    print(f"[times] ssd_scan B={b} S={s} H={h} P=64 N=128 chunk=256 bf16: kernel_ms {t_k:.4f} "
          f"plain_ms {t_plain:.4f} library_ms none (no PyTorch call computes the SSD) bound_ms "
          f"{bound_ms:.5f} ({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
          f"achieved {flops / t_k / 1e9:.2f} TFLOP/s, {nbytes / t_k / 1e9:.3f} TB/s, bound share "
          f"{bound_ms / t_k:.4f}; device launches per call {per_call:g}; scratch "
          f"{scratch} bytes (peak allocated during one call less y and the final state: "
          f"chunk states, decays, scores; not in the bound)")
    del args
    torch.cuda.empty_cache()
    return dict(shape=[b, s, h, 64, 128, 256], ms=t_k, plain_ms=t_plain, bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, bytes=nbytes, max_abs_err=err, device_launches=per_call)


def phase_times_ssd(rng) -> list:
    """K7 and its plain version (``ssd_time``) at the [ssm] prefill's shape
    (8, 2048), at one long sequence and at the first SSM training step's
    (2, 6144), with mamba2's 24 heads."""
    return [ssd_time(rng, b, s) for b, s in SSD_TIMES]


def phase_times_adamw() -> dict:
    """The multi-tensor AdamW at full-width Qwen3-0.6B's 311 leaves: one
    clipped step held against the plain version, then the kernel, the plain
    version and the library yardstick timed (module docstring, phase 19)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw
    from repro_torch.models import LM
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import tree_leaves

    shapes = [tuple(p.shape) for p in tree_leaves(LM(get_config("qwen3_0_6b"), device="meta").init())]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [(torch.randn(s, generator=gen, device="cuda") * 0.02).bfloat16() for s in shapes]
    grads = [(torch.randn(s, generator=gen, device="cuda") * 1e-3).bfloat16() for s in shapes]
    cfg = optimizer.OptimizerConfig()
    state = optimizer.init_opt_state(params, cfg)
    plain = [p.clone() for p in params]
    plain_state = optimizer.init_opt_state(plain, cfg)
    own = float(optimizer.global_norm(grads))
    adamw.reset_launches()
    metrics = optimizer.adamw_update(params, grads, state, cfg)
    launches = dict(adamw.LAUNCHES)
    norm = float(metrics["grad_norm"])
    patched, optimizer.global_norm = optimizer.global_norm, lambda tree: metrics["grad_norm"].clone()
    try:
        optimizer.adamw_update_plain(plain, grads, plain_state, cfg)
    finally:
        optimizer.global_norm = patched
    exact = all(torch.equal(a, b) for a, b in zip(tree_leaves([params, state]), tree_leaves([plain, plain_state])))
    check(norm > cfg.grad_clip and abs(norm - own) <= 1e-6 * own,
          f"adamw: norm {norm} against the plain {own} (rtol 1e-6; the step must be clipped)")
    check(exact, "adamw: p, m, v or the step differ from the plain version's given the kernel's norm")
    check(launches == ADAMW_STEP_LAUNCHES, f"adamw: launches {launches} for one step of 311 leaves")
    call = lambda: optimizer.adamw_update(params, grads, state, cfg)  # noqa: E731
    ms = cuda_ms(call, iters=20, warmup=3)
    per_call, kernels = device_launches(call)
    check(per_call == sum(launches.values()) and all("adamw_" in k for k in kernels),
          f"adamw: {per_call} device launches a call of the kernels {sorted(kernels)}, not {launches}")
    plain_ms = cuda_ms(lambda: optimizer.adamw_update_plain(plain, grads, plain_state, cfg), iters=5, warmup=1)
    del plain, plain_state
    torch.cuda.empty_cache()
    leaves = [p.detach().clone().requires_grad_() for p in params]
    for p, g in zip(leaves, grads):
        p.grad = g.clone()
    opt = torch.optim.AdamW(leaves, lr=cfg.lr, betas=cfg.betas, eps=cfg.eps,
                            weight_decay=cfg.weight_decay, fused=True)

    def library_step():
        torch.nn.utils.clip_grad_norm_(leaves, cfg.grad_clip, foreach=True)
        opt.step()

    library_ms = cuda_ms(library_step, iters=20, warmup=3)
    library_step_ms = cuda_ms(opt.step, iters=20, warmup=3)
    del leaves, opt
    n = sum(p.numel() for p in params)
    nbytes = 24 * n  # the norm reads g; the update reads p, g, m, v and writes p, m, v
    flops = 20.0 * n  # the square and sum, and the update's ~18 operations a weight
    bound_ms = 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    print(f"[times] adamw Qwen3-0.6B {len(shapes)} leaves {n} weights (bf16 weights and gradients, fp32 moments, "
          f"clipped: norm {norm:.6f}, plain {own:.6f}): kernel_ms {ms:.4f} (one call, CUDA events over 20) "
          f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (clip_grad_norm_ foreach + "
          f"AdamW fused, bf16 moments; the step alone {library_step_ms:.4f}) bound_ms {bound_ms:.4f} (bytes: "
          f"{nbytes / 1e9:.2f} GB) bound share {bound_ms / ms:.4f}; launches a step {sum(launches.values())}; "
          f"bitwise equal to the plain version given the kernel's norm")
    del params, grads, state
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_step_ms=library_step_ms, bound_ms=bound_ms, bytes=nbytes, launches=launches,
                leaves=len(shapes), weights=n, norm_rel_err=abs(norm - own) / own)


def ultrachat_segments(rng, rows: int, cap: int):
    """(rows, cap) int32 segment ids of UltraChat-like samples (lognormal,
    mean 1196, CV 0.48, 16-4471 tokens, as the DeepSeek-V2-Lite cell's
    traffic) packed first-fit into rows of ``cap`` slots, padding after."""
    import numpy as np

    sigma = math.sqrt(math.log(1 + 0.48**2))
    seg = np.zeros((rows, cap), np.int32)
    for r in range(rows):
        at, sid = 0, 1
        while True:
            n = int(np.clip(rng.lognormal(math.log(1196) - sigma**2 / 2, sigma), 16, 4471))
            if at + n > cap:
                break
            seg[r, at:at + n], at, sid = sid, at + n, sid + 1
    return seg


def mla_work(seg, heads: int) -> dict:
    """(FLOPs, bytes) of the MLA forward, dQ and dK/dV passes at segment ids
    ``seg`` (a (B, S) array): 2 (qk + v), 2 (2 qk + v) and 4 (qk + v) FLOPs
    per visible pair and head, qk 192 and v 128; q, k_nope, k_rope, v, out,
    dout, the gradients, the fp32 row statistics and the segment ids moved
    once.  The metric ``mla_roofline`` (odb_bench/metrics) counts the same."""
    import numpy as np

    qk, vd, rope = 192, 128, 64
    b, s = seg.shape
    lengths = [int(n) for row in seg for n in np.unique(row[row > 0], return_counts=True)[1]]
    p = heads * sum(n * (n + 1) // 2 for n in lengths)
    t = b * s
    q, kn, kr, v = 2 * t * heads * qk, 2 * t * heads * (qk - rope), 2 * t * rope, 2 * t * heads * vd
    stat, ids = 4 * t * heads, 4 * t
    return {"fwd": (2.0 * (qk + vd) * p, q + kn + kr + v + v + stat + ids),
            "dq": (2.0 * (2 * qk + vd) * p, q + kn + kr + v + v + 2 * stat + ids + q),
            "dkv": (4.0 * (qk + vd) * p, q + kn + kr + v + v + 2 * stat + ids + kn + kr + v),
            "pairs": p}


def phase_times_mla(rng) -> dict:
    """The MLA kernels at the DeepSeek-V2-Lite cell's shape (MLA_SHAPE, UltraChat
    segments, 16 heads, qk 192 over v 128, bf16, YaRN's scale): held against
    the plain version (out and the gradients at 2e-2 of 1 + |plain|, lse at
    2e-5), then the forward and the backward (dQ and dK/dV, with delta and the
    heads' rope sum) timed beside their bounds, the plain version, the
    model's plain blockwise path (``_mla_block_sdpa``, forward, and forward
    with backward) and, as a yardstick the port never calls, SDPA with the
    same boolean mask over the rope key repeated per head (forward)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mla_attention as mk
    from repro_torch.kernels.liveness import build_liveness_tables
    from repro_torch.models.attention import _mla_block_sdpa
    from repro_torch.models.layers import yarn_mscale

    rows, cap, heads = MLA_SHAPE
    scale = 192**-0.5 * yarn_mscale(40.0, 0.707) ** 2
    seg_np = ultrachat_segments(rng, rows, cap)
    seg = torch.from_numpy(seg_np).cuda()

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()

    q, k_nope, k_rope = draw(rows, cap, heads, 192), draw(rows, cap, heads, 128), draw(rows, cap, 64)
    v, do = draw(rows, cap, heads, 128), draw(rows, cap, heads, 128)
    block = mk.block_for(cap)
    tables = build_liveness_tables(seg, block_q=block, block_kv=block)
    mk.reset_launches()
    out, lse = mk.mla_attention_fwd(q, k_nope, k_rope, v, seg, scale=scale, tables=tables)
    grads = mk.mla_attention_bwd(q, k_nope, k_rope, v, seg, out, lse, do, scale=scale, tables=tables)
    p_out, p_lse = mk.mla_attention_ref(q, k_nope, k_rope, v, seg, True, scale)
    plain = mk.mla_attention_bwd_ref(q, k_nope, k_rope, v, seg, out, lse, do, True, scale)
    real = seg > 0
    errs = {}
    check(torch.allclose(lse[real], p_lse[real], atol=TOL["float32"], rtol=TOL["float32"]),
          f"mla lse vs plain: err {(lse[real] - p_lse[real]).abs().max().item()}")
    for name, ours, ref in zip(("out", "dq", "dk_nope", "dk_rope", "dv"), (out, *grads), (p_out, *plain)):
        a, b = ours[real].float(), ref[real].float()
        errs[name] = (a - b).abs().max().item()
        check(torch.allclose(a, b, atol=TOL["bfloat16"], rtol=TOL["bfloat16"]),
              f"mla {name} vs plain at {MLA_SHAPE}: err {errs[name]}")
    check(mk.LAUNCHES == {"mla_fwd": 1, "mla_bwd_dq": 1, "mla_bwd_dkv": 1}, f"mla launches {mk.LAUNCHES}")
    del p_out, p_lse, plain
    torch.cuda.empty_cache()

    fwd = lambda: mk.mla_attention_fwd(q, k_nope, k_rope, v, seg, scale=scale, tables=tables)  # noqa: E731
    bwd = lambda: mk.mla_attention_bwd(q, k_nope, k_rope, v, seg, out, lse, do, scale=scale,  # noqa: E731
                                       tables=tables)
    fwd_ms, bwd_ms = cuda_ms(fwd, iters=20), cuda_ms(bwd, iters=20)
    _, fwd_kernels = device_launches(fwd)
    per_call, kernels = device_launches(bwd)
    # each kernel's mean device ms a launch, by the profiler
    names = {"fwd": "mla_fwd_kernel", "dq": "mla_bwd_dq_kernel", "dkv": "mla_bwd_dkv_kernel"}
    kernel_ms = {kind: ms for name, (_, ms) in {**fwd_kernels, **kernels}.items()
                 for kind, kernel in names.items() if kernel in name}
    tables_ms = cuda_ms(lambda: build_liveness_tables(seg, block_q=block, block_kv=block), iters=20)
    plain_ms = cuda_ms(lambda: mk.mla_attention_ref(q, k_nope, k_rope, v, seg, True, scale), iters=2, warmup=1)
    pos = np.zeros_like(seg_np)  # within-segment positions, as the plain path masks causally
    for r, row in enumerate(seg_np):
        starts = [0, *(np.flatnonzero(np.diff(row)) + 1), cap]
        for a, b in zip(starts[:-1], starts[1:]):
            pos[r, a:b] = np.arange(b - a)
    pos = torch.from_numpy(pos).cuda()
    blockwise = lambda: _mla_block_sdpa(q[..., :128], q[..., 128:], k_nope, k_rope, v, pos, pos,  # noqa: E731
                                        seg, seg, None, True, scale)
    blockwise_ms = cuda_ms(blockwise, iters=3, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (q, k_nope, k_rope, v)]

    def blockwise_step():
        o = _mla_block_sdpa(leaves[0][..., :128], leaves[0][..., 128:], *leaves[1:], pos, pos, seg, seg,
                            None, True, scale)
        torch.autograd.grad(o, leaves, do)

    blockwise_step_ms = cuda_ms(blockwise_step, iters=3, warmup=1)
    del leaves
    torch.cuda.empty_cache()
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(-1, -1, heads, -1)], dim=-1)
    posc = torch.arange(cap, device="cuda")
    mask = ((posc[None, :] <= posc[:, None])[None] & (seg[:, :, None] == seg[:, None, :])
            & (seg[:, None, :] > 0))[:, None]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k_full, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale),
                         iters=10)
    del qt, kt, vt, mask, k_full
    torch.cuda.empty_cache()
    work = mla_work(seg_np, heads)
    bound = {k: 1e3 * max(work[k][0] / PEAK_FLOPS, work[k][1] / PEAK_BYTES) for k in ("fwd", "dq", "dkv")}
    by = {k: "operations" if work[k][0] / PEAK_FLOPS > work[k][1] / PEAK_BYTES else "bytes"
          for k in ("fwd", "dq", "dkv")}
    bwd_bound = bound["dq"] + bound["dkv"]
    print(f"[times] mla {MLA_SHAPE} (rows, slots, heads) qk 192 v 128 bf16, {work['pairs']} visible pairs x "
          f"heads, block {block}: fwd kernel_ms {fwd_ms:.4f} bound_ms {bound['fwd']:.4f} ({by['fwd']}) share "
          f"{bound['fwd'] / fwd_ms:.4f}; bwd (dq + dkv + delta + rope sum) kernel_ms {bwd_ms:.4f} bound_ms "
          f"{bwd_bound:.4f} share {bwd_bound / bwd_ms:.4f}; tables_ms {tables_ms:.4f}; plain_ms (fwd) "
          f"{plain_ms:.4f}; blockwise_ms (the plain path: fwd {blockwise_ms:.4f}, fwd + bwd "
          f"{blockwise_step_ms:.4f}); library_ms {library_ms:.4f} (SDPA fwd, boolean mask, rope key repeated); "
          f"bwd device launches {per_call} {sorted(kernels)}; by the profiler, each kernel's ms (share of its "
          f"bound): " + ", ".join(f"{k} {ms:.4f} ({bound[k] / ms:.4f})" for k, ms in kernel_ms.items())
          + f"; max_abs_err vs plain {errs}")
    return dict(ms=fwd_ms, bwd_ms=bwd_ms, bound_ms=bound["fwd"], bwd_bound_ms=bwd_bound, bound_by=by["fwd"],
                plain_ms=plain_ms, blockwise_ms=blockwise_ms, blockwise_step_ms=blockwise_step_ms,
                library_ms=library_ms, tables_ms=tables_ms, max_abs_err=errs, pairs=work["pairs"],
                kernel_ms=kernel_ms, kernel_bound_ms=bound,
                shape=list(MLA_SHAPE), block=block)


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

    def timed(phase, *args, **kwargs):
        t = time.perf_counter()
        out = phase(*args, **kwargs)
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
    chaos_launches = timed(phase_chaos, train_seg)
    archs = timed(phase_archs, np.random.default_rng(8))
    mla_hybrid = timed(phase_mla_hybrid, np.random.default_rng(12))
    mesh = timed(phase_mesh, train_seg)
    ep = timed(phase_ep, np.random.default_rng(16))
    serve_times = timed(phase_times, np.random.default_rng(1), serve_launches)[-1]  # (8, 256)
    times = timed(phase_times_training, np.random.default_rng(3), train_seg)
    arch_times = [timed(phase_times_training, np.random.default_rng(9 + i),
                        long_segments(np.random.default_rng(11 + i), 2, 4096)[0], label=label, **widths)
                  for i, (label, widths) in enumerate(ARCH_TIME_SHAPES)]
    ssd_times = timed(phase_times_ssd, np.random.default_rng(6))
    adamw_times = timed(phase_times_adamw)
    mla_times = timed(phase_times_mla, np.random.default_rng(20))
    for held in [*(rec["max_abs_err"] for rec in archs.values()), mla_hybrid["max_abs_err"], ep["max_abs_err"],
                 times["max_abs_err"],
                 *(at["max_abs_err"] for at in arch_times)]:
        for kname, err in held.items():
            max_err[kname] = max(max_err[kname], err)
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
        entry.update(launches_chaos=chaos_launches[kname],
                     launches_chaos_note="one full-width Standard step (dense layout, flash)"
                     if grid == "dense" else f"one {TRAIN_STEPS}-step run of the chaos phase's "
                     "fault runs (packed, streaming with prefetch and staging)")
        if grid == "dense":
            entry.update(launches_dp_train=dp_launches[kname],
                         launches_dp_train_note=f"per rank, {DP_STEPS} dp_step steps at world 2 "
                                                "over gloo (dense layout, flash route)")
        else:
            entry.update(launches_autotune_run=probes["launches"][kname],
                         launches_autotune_run_note=f"{PROBE_STEPS} training steps with "
                                                    "--attn-autotune, its block probes included")
        entry.update(
            launches_archs={run: rec["launches"][kname] for run, rec in archs.items()},
            launches_archs_note="per run of the archs phase: OLMo-1B 4 training steps, HuBERT-XLarge "
                                "one loss with its gradients, the four served models' engine runs",
            arch_shapes=[dict(label=label, shape=at["shape"], causal=at["causal"], ms=at[kname]["ms"],
                              plain_ms=at[kname]["plain_ms"], bound_ms=at[kname]["bound_ms"],
                              bound_by=at[kname]["bound_by"], library_ms=at[kname]["library_ms"])
                         for (label, _), at in zip(ARCH_TIME_SHAPES, arch_times)],
        )
        if grid == "pruned":
            entry.update(launches_mla_hybrid={run: rec[kname] for run, rec in mla_hybrid["launches"].items()},
                         launches_mla_hybrid_note=MLA_HYBRID_NOTE)
        entry.update(launches_mesh=mesh["launches"][kname],
                     launches_mesh_note="the mesh phase: validate_flash_sharded in bf16 and fp32 on "
                                        f"its grid at 2 x {train_seg.shape[1]} (world 1 over NCCL; per rank "
                                        f"at world 2 over gloo); {MESH_TRAIN_STEPS} remat='dots' training "
                                        "steps of full-width Qwen3-0.6B")
        entry.update(launches_ep={run: dict(serve=ep["launches"][run][kname], loss=ep["loss_launches"][run][kname])
                                  for run in ep["runs"]},
                     launches_ep_note=EP_NOTE)
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
        launches=ssm_train["launches"],
        max_abs_err=max(ssd_err, main_shape["max_abs_err"], mla_hybrid["ssd"]["max_abs_err"],
                        mla_hybrid["ssd"]["loss_shape_max_abs_err"]),
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
        launches_mla_hybrid={run: rec["ssd_scan"] for run, rec in mla_hybrid["launches"].items()},
        launches_mla_hybrid_note=MLA_HYBRID_NOTE,
        launches_ep={run: dict(serve=ep["launches"][run]["ssd_scan"], loss=ep["loss_launches"][run]["ssd_scan"])
                     for run in ep["runs"]},
        launches_ep_note=EP_NOTE,
        jamba_shape={key: mla_hybrid["ssd"][key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                             "max_abs_err", "loss_shape_max_abs_err")},
    ))
    kernels.append(dict(
        name="adamw", route="cuda", source=ADAMW, replaces=ADAMW_REPLACES,
        launches=train_launches["adamw"], launches_note=f"{TRAIN_STEPS} training steps of Qwen3-0.6B's 311 "
                                                        "leaves, the [train] phase's pruned default-path run",
        launches_times=adamw_times["launches"], launches_times_note="the times phase's one held step",
        ms=adamw_times["ms"], plain_ms=adamw_times["plain_ms"],
        bound_ms=adamw_times["bound_ms"], bound_by="bytes", library_ms=adamw_times["library_ms"],
        library_step_ms=adamw_times["library_step_ms"], norm_rel_err=adamw_times["norm_rel_err"],
        shape=[adamw_times["leaves"], adamw_times["weights"]], dtype="bfloat16 weights, float32 moments",
    ))
    kernels.append(dict(
        name="mla_attention", route="cuda", source=MLA, replaces=MLA_REPLACES,
        launches_mla_hybrid=mla_hybrid["launches"]["deepseek_v3_671b_loss"],
        launches_mla_hybrid_note=MLA_HYBRID_NOTE,
        ms=mla_times["ms"], bwd_ms=mla_times["bwd_ms"], kernel_ms=mla_times["kernel_ms"],
        bound_ms=mla_times["bound_ms"], bwd_bound_ms=mla_times["bwd_bound_ms"],
        kernel_bound_ms=mla_times["kernel_bound_ms"], bound_by=mla_times["bound_by"],
        plain_ms=mla_times["plain_ms"], blockwise_ms=mla_times["blockwise_ms"],
        blockwise_step_ms=mla_times["blockwise_step_ms"], library_ms=mla_times["library_ms"],
        tables_ms=mla_times["tables_ms"], max_abs_err=mla_times["max_abs_err"],
        shape=mla_times["shape"], dtype="bfloat16",
    ))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
