"""Rank processes for the port's torch.distributed tests (gloo on the CPU).

Spawned by tests/test_torch_dp.py and tests/test_torch_comm.py.  This module
imports torch and the port only, never JAX, so a spawned rank starts in
about a second.  Inputs and results travel as pickles the tests write
themselves under ``tmp_path``.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import time

import torch
import torch.distributed as dist


def init_group(rank: int, world: int, init_file: str, timeout_s: float = 60.0) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def rank_rows(batch: dict, rank: int, world: int) -> dict:
    """This rank's contiguous block of the global batch's rows."""
    b = next(iter(batch.values())).shape[0]
    rows = slice(rank * b // world, (rank + 1) * b // world)
    return {k: torch.from_numpy(v[rows]) for k, v in batch.items()}


def dp_rank(rank: int, world: int, init_file: str, inputs_path: str, out_path: str) -> None:
    """Run ``dp_step`` once per entry of the inputs' ``runs`` (loss mode,
    compression), each from the same initial weights; pickle the metrics,
    the reduced gradients (through ``params_to_jax``) and the parameters
    after the step."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    init_group(rank, world, init_file)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), **inp["cfg"])
        model = LM(cfg, device="cpu")
        opt_cfg = OptimizerConfig()
        batch = rank_rows(inp["batch"], rank, world)
        captured = []
        update = trainer.adamw_update

        def capture(params, grads, opt_state, ocfg):
            captured.append(params_to_jax(grads, cfg))
            return update(params, grads, opt_state, ocfg)

        trainer.adamw_update = capture
        out = []
        for loss_mode, compress in inp["runs"]:
            captured.clear()
            params = model.load_params(params_from_jax(inp["params"], cfg, device="cpu"))
            state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
            step, init_error_state = trainer.dp_step(
                model, opt_cfg, loss_mode=loss_mode, compress_grads=compress)
            state, metrics, _ = step(state, batch, init_error_state(params))
            out.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": captured[0],
                "params": params_to_jax(state["params"], cfg),
            })
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def gather_rank(rank: int, world: int, init_file: str, out_path: str, scenario: str) -> None:
    """``TorchProcessCollective`` scenarios; pickles what rank ``rank`` saw."""
    import numpy as np

    from repro_torch.core.comm import (
        ProtocolDesyncError,
        RankTimeoutError,
        ResilientCollective,
        TorchProcessCollective,
        decode_round_payload,
        encode_round_payload,
    )

    init_group(rank, world, init_file, timeout_s=20.0)
    seen: dict = {}
    try:
        coll = TorchProcessCollective(world)
        if scenario == "roundtrip":
            payload = {"idx_budget": 10 + rank, "n_groups": rank - 1, "sizes": [rank + 1],
                       "tokens": [100 * (rank + 1)]}
            vecs = coll.all_gather(rank, encode_round_payload(payload, group_capacity=2))
            seen["payloads"] = [decode_round_payload(v, group_capacity=2) for v in vecs]
            seen["rounds"] = coll.stats.rounds
            resilient = ResilientCollective(coll, deadline_s=10.0)
            seen["resilient"] = [v.tolist() for v in resilient.all_gather(rank, np.arange(3) * rank)]
        elif scenario == "desync":
            # rank 0 opens a primary round while rank 1 sends a secondary one
            try:
                coll.all_gather(rank, np.zeros(2), tag="primary" if rank == 0 else "secondary")
            except ProtocolDesyncError as exc:
                seen["desync"] = str(exc)
        elif scenario == "timeout":
            # rank 1 never gathers: rank 0 must surface RankTimeoutError by
            # its deadline, while rank 1 keeps the group alive past it
            if rank == 0:
                resilient = ResilientCollective(coll, deadline_s=0.5, max_retries=2)
                t0 = time.monotonic()
                try:
                    resilient.all_gather(rank, np.zeros(2))
                except RankTimeoutError as exc:
                    seen["timeout"] = (time.monotonic() - t0, exc.attempts, exc.failed_ranks)
            else:
                time.sleep(2.0)
        with open(out_path, "wb") as f:
            pickle.dump(seen, f)
    finally:
        if scenario != "timeout":
            dist.destroy_process_group()


def cuda_reduce_rank(rank: int, world: int, init_file: str, out_path: str) -> None:
    """Two gloo ranks sharing one card: ``all_reduce`` of CUDA tensors in
    fp32 and bf16, and a ``TorchProcessCollective`` gather beside it."""
    import numpy as np

    from repro_torch.core.comm import TorchProcessCollective

    torch.cuda.set_device(0)
    init_group(rank, world, init_file)
    try:
        seen = {}
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.full((1 << 20,), float(rank + 1), dtype=dtype, device="cuda")
            dist.all_reduce(t)
            seen[str(dtype)] = (t.device.type, float(t.float().min()), float(t.float().max()))
        seen["gather"] = [v.tolist() for v in TorchProcessCollective(world).all_gather(
            rank, np.arange(2) + rank)]
        with open(out_path, "wb") as f:
            pickle.dump(seen, f)
    finally:
        dist.destroy_process_group()
