"""The flash route under a mesh: each data shard runs the flash kernels on
its own rows.

:func:`validate_flash_sharded` gives every rank of the mesh's data axes
``rows_per_shard`` rows of the global batch and runs
``kernels/ops.flash_attention`` forward and backward on the loss
``sum(out.float() ** 2)``.  On the pruned grid the liveness tables are built
from the rank's own segments (per-shard tables, no global table exchange:
what a real multi-host run needs).  The per-shard losses are summed over
the process group.  On CUDA tensors that launches K1-K3 (``grid="dense"``)
or K4-K6 (``grid="pruned"``); on CPU tensors their plain versions.  The
JAX package compiles this cell for its production mesh; the port runs it.

As a module (``python -m repro_torch.launch.flash_dryrun``) it runs both
grids and writes ``artifacts/dryrun_torch/flash_sharded.json``:

* ``--mesh single`` / ``multi`` (the production 16x16 / 2x16x16 mesh under
  a fake process group of 256 / 512 ranks): this process is rank 0 and runs
  rank 0's rows (the fake group's all-reduce adds nothing);
* ``--mesh host``: ``(world, 1)`` over a real group, initialised from the
  environment when ``WORLD_SIZE`` is set (``torchrun --nproc-per-node 2
  -m repro_torch.launch.flash_dryrun --mesh host --device cpu``), else a
  group of one.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
import traceback

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def make_inputs(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int, seed: int = 0):
    """(q, k, v, segments) of a global batch on the CPU: fp32 normals and
    packed segments (ids 1, 2, ... of 1/8 to 1/2 of a row each, a padded
    tail), drawn from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((batch, seq, n, head_dim), dtype=np.float32))
               for n in (heads, kv_heads, kv_heads))
    seg = np.zeros((batch, seq), np.int32)
    for row in range(batch):
        at, sid = 0, 1
        while at < seq - seq // 8:
            n = int(rng.integers(max(seq // 8, 1), max(seq // 2, 2)))
            seg[row, at:at + n] = sid
            at, sid = at + n, sid + 1
    return q, k, v, torch.from_numpy(seg)


def validate_flash_sharded(
    mesh,
    grid: str,
    *,
    rows_per_shard: int = 2,
    seq: int = 512,
    heads: int = 4,
    kv_heads: int = 2,
    head_dim: int = 64,
    block_q: int = 128,
    block_kv: int = 128,
    dtype: str = "float32",
    device=None,
    inputs=None,
    seed: int = 0,
    keep: bool = False,
) -> dict:
    """Run the sharded flash cell on this rank; returns its record.

    The global batch is ``rows_per_shard x dp_size(mesh)`` rows: ``inputs``
    (q, k, v, segments on the CPU, of that batch) or :func:`make_inputs`
    from ``seed``.  Ranks of one data shard with another ``model``
    coordinate run the same rows and add nothing to the summed loss.  With
    ``keep`` the record also holds this rank's out, dq, dk and dv (as CPU
    tensors, under ``"tensors"``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.launch.mesh import dp_index, dp_size, mesh_shape

    dp = dp_size(mesh)
    b = rows_per_shard * dp
    shard = dp_index(mesh)
    rows = slice(shard * rows_per_shard, (shard + 1) * rows_per_shard)
    record = {
        "grid": grid,
        "mesh": mesh_shape(mesh),
        "batch": b,
        "seq": seq,
        "heads": heads,
        "kv_heads": kv_heads,
        "head_dim": head_dim,
        "rows_per_shard": rows_per_shard,
        "rows": [rows.start, rows.stop],
        "dtype": dtype,
        "compile_only": False,
    }
    try:
        dev = resolve_device(device)
        record["device"] = str(dev)
        if inputs is None:
            inputs = make_inputs(b, seq, heads, kv_heads, head_dim, seed)
        if inputs[0].shape[:2] != (b, seq):
            raise ValueError(f"inputs of shape {tuple(inputs[0].shape)}; the mesh wants ({b}, {seq})")
        dt = getattr(torch, dtype)
        q, k, v = (t[rows].to(dev, dt).contiguous().requires_grad_() for t in inputs[:3])
        seg = inputs[3][rows].to(dev).contiguous()
        record["argument_bytes"] = sum(t.nbytes for t in (q, k, v, seg))
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        out = flash_attention(q, k, v, seg, True, block_q, block_kv, grid)
        loss = (out.float() ** 2).sum()
        dq, dk, dv = torch.autograd.grad(loss, (q, k, v))
        local = loss.detach()
        if cuda:
            torch.cuda.synchronize(dev)
        record["run_s"] = round(time.perf_counter() - t0, 6)
        record["launches"] = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        record["temp_bytes"] = torch.cuda.max_memory_allocated(dev) - base if cuda else None
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        total = local * (coord.get("model", 0) == 0)
        dist.all_reduce(total)
        record["local_loss"] = float(local)
        record["loss"] = float(total)
        if keep:
            record["tensors"] = {name: t.detach().cpu() for name, t in
                                 zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv))}
        record["status"] = "ok"
    except Exception as exc:  # reported in the record; main() exits 1 on it
        record["status"] = "error"
        record["error"] = f"{type(exc).__name__}: {exc}"
        record["traceback"] = traceback.format_exc(limit=12)
    return record


def _host_group(device: str) -> None:
    import torch.distributed as dist

    backend = "nccl" if device != "cpu" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _run_grids(mesh, args) -> dict:
    import torch.distributed as dist

    records = {}
    for grid in ("dense", "pruned"):
        rec = validate_flash_sharded(mesh, grid, rows_per_shard=args.rows_per_shard, seq=args.seq,
                                     device=args.device)
        records[grid] = rec
        if not args.json:
            print(f"[flash-dryrun] rank {dist.get_rank()} grid={grid} mesh={args.mesh} "
                  f"ranks={dist.get_world_size()} rows={rec['rows']} status={rec['status']} "
                  f"run={rec.get('run_s', float('nan'))}s loss={rec.get('loss')} "
                  f"launches={rec.get('launches')}")
            if rec["status"] != "ok":
                print(rec.get("traceback", rec.get("error", "")))
    return {"device": records["dense"].get("device"), "devices": dist.get_world_size(),
            "rank": dist.get_rank(), "cells": records}


def main() -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world, make_host_mesh, make_production_mesh, production_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=("single", "multi", "host"),
                    help="production mesh (single-pod 16x16 or two-pod 2x16x16) under a fake "
                         "process group, running rank 0's rows; or host: (world, 1) over a real group")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--rows-per-shard", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="print the record JSON")
    args = ap.parse_args()

    if args.mesh == "host":
        _host_group(args.device or "cuda")
        try:
            out = _run_grids(make_host_mesh(), args)
        finally:
            dist.destroy_process_group()
    else:
        with fake_world(production_world(args.mesh == "multi")):
            out = _run_grids(make_production_mesh(multi_pod=args.mesh == "multi"), args)
    if out["rank"] == 0:
        ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
        path = ARTIFACT_DIR / "flash_sharded.json"
        path.write_text(json.dumps(out, indent=1))
        if not args.json:
            print(f"[flash-dryrun] artifact: {path}")
    if args.json:
        print(json.dumps(out))
    if any(r["status"] != "ok" for r in out["cells"].values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
