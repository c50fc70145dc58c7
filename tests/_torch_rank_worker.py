"""Rank processes for the port's torch.distributed tests (gloo on the CPU).

Spawned by tests/test_torch_dp.py, tests/test_torch_comm.py,
tests/test_torch_dryrun.py and tests/test_torch_ep.py.  This module imports torch and the port only,
never JAX, so a spawned rank starts in about a second.  Inputs and results travel as pickles the tests write
themselves under ``tmp_path``.
"""

from __future__ import annotations

import contextlib
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


def flash_rank(rank: int, world: int, init_file: str, inputs_path: str, out_path: str) -> None:
    """``validate_flash_sharded`` on a ``(world, 1)`` host mesh, both grids,
    on the inputs' global batch; pickles each record with this rank's out,
    dq, dk and dv.  One thread: the ranks share the cores, and a reduction
    split over however many threads a busy machine grants is not bitwise
    repeatable."""
    from repro_torch.launch.flash_dryrun import validate_flash_sharded
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    init_group(rank, world, init_file)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        mesh = make_host_mesh()
        out = {}
        for grid in ("dense", "pruned"):
            out[grid] = validate_flash_sharded(
                mesh, grid, inputs=tuple(torch.from_numpy(x) for x in inp["inputs"]), keep=True,
                device="cpu", **inp["widths"])
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def counted_pairs(sink: list):
    """Within the block, every MoE dispatch appends to ``sink`` the (token,
    expert) pairs it kept and those of its own experts it dropped at
    capacity."""
    from repro_torch.models import moe

    slots = moe.dispatch_slots

    def counted(ids, n_local, capacity, e_start=0):
        dest_e, dest_c, keep = slots(ids, n_local, capacity, e_start)
        local = ids.reshape(-1) - e_start
        in_range = (local >= 0) & (local < n_local)
        sink.append((int(keep.sum()), int((in_range & ~keep).sum())))
        return dest_e, dest_c, keep

    moe.dispatch_slots = counted
    try:
        yield sink
    finally:
        moe.dispatch_slots = slots


def ep_moe_case(case: dict, mesh) -> dict:
    """One EP ``moe_ffn`` call on this rank's shard of the case's full MoE
    tree: the output, the gradients of ``sum(y * w)`` (every leaf gathered
    back over ``model``, and the tokens'), and the kept / dropped pairs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import gather_moe_params, local_moe_params
    from repro_torch.models import moe

    import numpy as np

    cfg = dataclasses.replace(get_smoke_config(case["arch"]), first_k_dense=0, **case["overrides"])
    full = {"layers": [{"moe": case["moe"], **({"mlp": case["dense"]} if case["dense"] else {})}]}
    tree = _tree_like(local_moe_params(full, cfg, mesh)["layers"][0],
                      lambda a: torch.from_numpy(np.array(a)).requires_grad_())
    x = torch.from_numpy(case["x"]).requires_grad_()
    pairs: list = []
    with counted_pairs(pairs):
        y = moe.moe_ffn(tree["moe"], x, cfg, mesh=mesh, dense_params=tree.get("mlp"),
                        dispatch_chunks=case["chunks"])
    leaves = _leaves(tree)
    grads = torch.autograd.grad((y * torch.from_numpy(case["w"])).sum(), [x, *leaves])
    by_id = dict(zip(map(id, leaves), grads[1:]))
    gathered = gather_moe_params({"layers": [_tree_like(tree, lambda t: by_id[id(t)])]}, cfg, mesh)
    return {"y": y.detach().numpy(), "dx": grads[0].numpy(), "pairs": pairs,
            "grads": _tree_like(gathered["layers"][0], lambda t: t.numpy())}


def ep_rank(rank: int, world: int, init_file: str, inputs_path: str, out_path: str) -> None:
    """Expert parallelism over a ``(1, world)`` host mesh: every MoE case of
    the inputs (``ep_moe_case``), then, when the inputs carry them, one
    smoke ``LM.loss_sums`` with its gradients (gathered to the JAX layout)
    and one engine run on this rank's shard of the JAX weights.  One thread:
    the ranks share the cores."""
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    init_group(rank, world, init_file)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        mesh = make_host_mesh(world)
        out = {"cases": [ep_moe_case(case, mesh) for case in inp["cases"]]}
        if "lm" in inp:
            out.update(ep_lm(inp["lm"], mesh))
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def ep_lm(inp: dict, mesh) -> dict:
    """``LM(cfg, mesh=mesh)`` from this rank's shard of the JAX weights: the
    loss sums and gradients of the inputs' batch, then the engine serving
    the inputs' trace; returns the loss, the gathered gradients (JAX
    layout), the kept / dropped pairs of the loss and the generated ids."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig

    cfg = dataclasses.replace(get_smoke_config(inp["arch"]), **inp["overrides"])
    model = LM(cfg, device="cpu", mesh=mesh)
    params = model.load_params(params_from_jax(inp["params"], cfg, device="cpu", mesh=mesh))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    pairs: list = []
    with counted_pairs(pairs):
        loss_sum, tokens = model.loss_sums(params, batch)
    leaves = _leaves(params)
    grads = torch.autograd.grad(loss_sum / tokens, leaves)
    by_id = dict(zip(map(id, leaves), grads))
    gtree = _tree_like(params, lambda t: by_id[id(t)])
    engine = ContinuousBatchingEngine(model, params, ServeConfig(**inp["serve"]), mesh=mesh,
                                      device="cpu")
    rids = [engine.submit(p, n) for p, n in inp["trace"]]
    outputs = engine.run()
    return {"loss": float(loss_sum.detach() / tokens), "lm_pairs": pairs,
            "lm_grads": params_to_jax(gtree, cfg, mesh=mesh),
            "ids": [list(map(int, outputs[r])) for r in rids]}


def _tree_like(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]
