"""The port's dry run, its roofline and the sharded flash check against the
JAX package, on the CPU.

* ``validate_flash_sharded`` on a ``(2, 1)`` mesh over gloo, in two spawned
  ranks (``tests/_torch_rank_worker.py``), both grids: each rank's rows of
  out, dQ, dK and dV equal to the port's single-process call on the whole
  batch, and to the JAX ``kernels.ops.flash_attention`` (its Pallas kernels
  in interpret mode) at ``tests/test_kernels.py::_tol``'s fp32 2e-5.
* ``run_cell`` on smoke configs over a 2x4 fake mesh: every placement
  divides; the state's bytes per device equal the sum of local shard bytes
  computed from JAX's specs; the modelled collectives equal a count made by
  hand here for a dense config and, with FSDP forced on, an MoE one.
* The counted FLOPs of smoke train steps against JAX ``hlo_cost.analyze``
  of the same step compiled on one CPU device: equal for Qwen3 and Arctic,
  within 4 % for mamba2 (measured 3.06 % and 2.84 %: the plain chunked SSD
  and JAX's ``ssd_chunked`` contract in other orders).
* ``model_flops_for_cell`` equal to JAX's; ``perf.py`` on one cell;
  ``flash_dryrun.main``; a full-width cell ``ok``.

Every fake process group is entered and destroyed inside ``run_cell``.
"""

import json
import math
import multiprocessing as mp
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_worker
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.launch import sharding as jax_sharding
from repro.launch import shapes as jax_shapes
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import LM as JaxLM
from repro.roofline import analysis as jax_analysis
from repro.roofline.hlo_cost import analyze as hlo_analyze
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels.ops import flash_attention
from repro_torch.launch import dryrun, perf, sharding
from repro_torch.launch.flash_dryrun import make_inputs
from repro_torch.launch.shapes import SHAPE_ORDER, SHAPES, ShapeCell
from repro_torch.models import LM
from repro_torch.roofline import analysis
from repro_torch.train import optimizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

FLASH_WIDTHS = dict(rows_per_shard=2, seq=256, heads=4, kv_heads=2, head_dim=16, block_q=64, block_kv=128)
TOL = dict(atol=2e-5, rtol=2e-5)
SMOKE_CELL = ShapeCell("smoke_train", 64, 8, "train")


# -- the sharded flash check ------------------------------------------------------


def _spawn(target, world: int, args_of) -> None:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(rank)) for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def flash_world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flash")
    w = FLASH_WIDTHS
    inputs = make_inputs(2 * w["rows_per_shard"], w["seq"], w["heads"], w["kv_heads"], w["head_dim"], seed=3)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"inputs": [t.numpy() for t in inputs], "widths": w}, f)
    _spawn(_torch_rank_worker.flash_rank, 2,
           lambda r: (r, 2, str(tmp / "pg"), str(tmp / "inputs.pkl"), str(tmp / f"out{r}.pkl")))
    ranks = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _single_process(inputs, grid: str):
    """The whole batch in this process, on one thread as the ranks run."""
    w = FLASH_WIDTHS
    q, k, v = (t.clone().requires_grad_() for t in inputs[:3])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = flash_attention(q, k, v, inputs[3], True, w["block_q"], w["block_kv"], grid)
        loss = (out.float() ** 2).sum()
        grads = torch.autograd.grad(loss, (q, k, v))
    finally:
        torch.set_num_threads(threads)
    return loss.detach(), {"out": out.detach(), **dict(zip(("dq", "dk", "dv"), grads))}


@pytest.mark.parametrize("grid", ["dense", "pruned"])
def test_sharded_flash_equals_single_process(flash_world2, grid):
    inputs, ranks = flash_world2
    loss, whole = _single_process(inputs, grid)
    for rank, recs in enumerate(ranks):
        rec = recs[grid]
        assert rec["status"] == "ok", rec.get("traceback")
        rows = slice(*rec["rows"])
        assert rec["rows"] == [2 * rank, 2 * rank + 2] and rec["mesh"] == {"data": 2, "model": 1}
        for name, t in rec["tensors"].items():
            assert torch.equal(t, whole[name][rows]), (rank, name)
    assert ranks[0][grid]["loss"] == ranks[1][grid]["loss"]
    np.testing.assert_allclose(ranks[0][grid]["loss"], float(loss), rtol=1e-6)
    np.testing.assert_allclose(sum(r[grid]["local_loss"] for r in ranks), float(loss), rtol=1e-6)


@pytest.mark.parametrize("grid", ["dense", "pruned"])
def test_sharded_flash_matches_jax(flash_world2, grid):
    inputs, ranks = flash_world2
    w = FLASH_WIDTHS
    q, k, v, seg = (jnp.asarray(t.numpy()) for t in inputs)

    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, seg, True, w["block_q"], w["block_kv"], grid)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    theirs = {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
    for recs in ranks:
        rows = slice(*recs[grid]["rows"])
        for name, t in recs[grid]["tensors"].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(theirs[name])[rows], err_msg=name, **TOL)


# -- the dry run on smoke configs -----------------------------------------------------


def _jax_mesh(shape: dict):
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _is_spec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


def _jax_leaves(tree, specs) -> list:
    return list(zip(jax.tree.leaves(tree), jax.tree.leaves(specs, is_leaf=_is_spec)))


def _jax_local_bytes(tree, specs, shape: dict) -> int:
    """Bytes per device from JAX's specs (a stacked leaf counted whole: its
    layer axis is never sharded)."""
    total = 0
    for leaf, spec in _jax_leaves(tree, specs):
        dims = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                dims[d] //= shape[a]
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


MESH_2X4 = {"data": 2, "model": 4}
ACTIVATION = 4 * 64 * 64 * 4  # (4 rows, 64 tokens, d_model 64) fp32, one data shard


def _smoke(arch: str):
    """The port's record of the smoke train cell on data 2 x model 4, and
    JAX's params and specs of the same config."""
    cfg = get_smoke_config(arch)
    rec = dryrun.run_cell(arch, "smoke_train", "2x4", cfg=cfg, cell=SMOKE_CELL, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    jcfg = jax_smoke_config(arch)
    jparams = jax.eval_shape(JaxLM(jcfg).init, jax.random.PRNGKey(0))
    return cfg, rec, jparams, jax_sharding.param_specs(jparams, jcfg, _jax_mesh(MESH_2X4))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "arctic_480b"])
def test_smoke_cell_state_bytes_from_jax_specs(arch):
    cfg, rec, jparams, jspecs = _smoke(arch)
    jopt = jax.eval_shape(lambda p: jax_init_opt_state(p, JaxOptimizerConfig()), jparams)
    parts = rec["bytes_parts"]
    assert rec["leaves_checked"] > 0 and rec["local_rows"] == 4 and rec["chips"] == 8
    assert parts["params"] == parts["grads"] == _jax_local_bytes(jparams, jspecs, MESH_2X4)
    assert parts["opt_moments"] == _jax_local_bytes(jopt, jax_sharding.opt_state_specs(jopt, jspecs), MESH_2X4)
    assert parts["batch"] == 3 * 4 * 64 * 4  # tokens, labels (int32), loss_mask (fp32) of 4 rows
    assert parts["caches"] == 0 and parts["activations"] > 0
    assert rec["bytes_per_device"] == sum(parts.values()) and rec["fits"]


def _tp_sites(jspecs, n_layers: int) -> int:
    """Row-parallel outputs of one forward from JAX's stacked specs: each
    layer's ``wo`` and its FFN's ``w_out`` (the MoE's expert slab stands for
    the MoE, its dense residual summed in)."""
    unit = jspecs["stack"]["sub0"]
    ffn = unit["moe"]["w_out"] if "moe" in unit else unit["mlp"]["w_out"]
    return n_layers * ((tuple(unit["mixer"]["wo"])[1] == "model") + (tuple(ffn)[1] == "model"))


def test_smoke_cell_collectives_dense_by_hand():
    """Qwen3 smoke on data 2 x model 4, no FSDP: one all-reduce over
    ``data`` of each leaf's local gradient, and per layer two TP all-reduces
    of the shard's activations, forward and backward."""
    cfg, rec, jparams, jspecs = _smoke("qwen3_0_6b")
    sites = _tp_sites(jspecs, cfg.n_layers)
    assert sites == 4
    coll = rec["per_collective"]
    assert coll["all-reduce"] == _jax_local_bytes(jparams, jspecs, MESH_2X4) + 2 * sites * ACTIVATION
    assert coll["all-gather"] == coll["reduce-scatter"] == 0
    port_leaves = len(optimizer.tree_leaves(LM(cfg, device="meta").init()))
    assert coll["per_op_counts"]["all-reduce"] == port_leaves + 2 * sites
    assert rec["parsed_cost"]["coll_bytes"] == coll["all-reduce"]


def test_smoke_cell_collectives_moe_fsdp_by_hand(monkeypatch):
    """Arctic smoke (MoE with a dense residual) with FSDP forced on: per
    leaf stored over ``data``, two all-gathers of its shard (remat "full")
    and a reduce-scatter of its shard gathered over ``data`` (twice its
    bytes); every other leaf one all-reduce over ``data``; per layer two TP
    sites (``wo``, the MoE) forward and backward."""
    monkeypatch.setattr(sharding, "FSDP_THRESHOLD", 0)
    monkeypatch.setattr(jax_sharding, "FSDP_THRESHOLD", 0)
    cfg, rec, jparams, jspecs = _smoke("arctic_480b")
    stored = [(leaf, spec) for leaf, spec in _jax_leaves(jparams, jspecs) if "data" in tuple(spec)]
    rest = [(leaf, spec) for leaf, spec in _jax_leaves(jparams, jspecs) if "data" not in tuple(spec)]
    fsdp = sum(_jax_local_bytes(leaf, spec, MESH_2X4) for leaf, spec in stored)
    replicated = sum(_jax_local_bytes(leaf, spec, MESH_2X4) for leaf, spec in rest)
    assert fsdp > 0 and replicated > 0
    sites = _tp_sites(jspecs, cfg.n_layers)
    assert sites == 4
    coll = rec["per_collective"]
    assert coll["all-gather"] == 2 * fsdp
    assert coll["reduce-scatter"] == 2 * fsdp
    assert coll["all-reduce"] == replicated + 2 * sites * ACTIVATION


# -- FLOPs against JAX's hlo_cost, the roofline, perf, full-width cells ------------------

# Counted FLOPs / hlo_cost FLOPs, as first measured: exact for the attention
# stacks (both layouts); 1.0306 (dense) and 1.0284 (packed) for mamba2 (the
# SSD's contractions).
FLOP_RTOL = {"qwen3_0_6b": 0.0, "arctic_480b": 0.0, "mamba2_130m": 0.04}


@pytest.mark.parametrize("arch,layout", [("qwen3_0_6b", "dense"), ("qwen3_0_6b", "packed"),
                                         ("arctic_480b", "dense"), ("mamba2_130m", "dense")])
def test_counted_flops_match_hlo_cost(arch, layout):
    s, b = (256, 2) if layout == "dense" else (128, 4)
    mesh = jax_host_mesh()
    assert mesh.devices.size == 1
    with jax.set_mesh(mesh):
        fn, args, _ = jax_build_train_step(
            JaxLM(jax_smoke_config(arch)), mesh, jax_shapes.ShapeCell("smoke", s, b, "train", layout=layout))
        theirs = hlo_analyze(fn.lower(*args).compile().as_text())["flops"]
    rec = dryrun.run_cell(arch, "smoke", "1x1", cfg=get_smoke_config(arch),
                          cell=ShapeCell("smoke", s, b, "train", layout=layout), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    ours = rec["parsed_cost"]["flops"]
    assert ours == rec["counted"]["flops"]  # one device: nothing split
    if FLOP_RTOL[arch]:
        assert abs(ours / theirs - 1) <= FLOP_RTOL[arch], (ours, theirs)
    else:
        assert ours == theirs


def test_model_flops_and_roofline_match_jax():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name in SHAPE_ORDER:
            assert analysis.model_flops_for_cell(cfg, SHAPES[name]) == \
                jax_analysis.model_flops_for_cell(jcfg, jax_shapes.SHAPES[name]), (arch, name)
    parsed = {"flops": 3e12, "hbm_bytes": 2e11, "coll_bytes": 5e9}
    ours = analysis.roofline_from_artifacts("a", "s", "single", 256, parsed, 1e15)
    theirs = jax_analysis.roofline_from_artifacts("a", "s", "single", 256, parsed, 1e15)
    assert ours.hlo_flops == theirs.hlo_flops and ours.model_flops == theirs.model_flops
    # the same formulas at an H100's peaks
    assert ours.compute_s == 3e12 / 989e12 and ours.memory_s == 2e11 / 3.35e12
    assert ours.collective_s == 5e9 / 450e9 and ours.dominant == "memory"
    assert set(ours.row()) == set(theirs.row())


def test_perf_variant_deltas(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", tmp_path)
    for variant in ("headshard", "ce_bf16"):
        monkeypatch.setattr(sys, "argv", ["perf", "--cell", "qwen3_0_6b:decode_32k", "--variant", variant])
        perf.main()
        out = capsys.readouterr().out
        assert "baseline → " + variant in out and "bound_time" in out
    base = json.loads((tmp_path / "qwen3_0_6b__decode_32k__single.json").read_text())
    head = json.loads((tmp_path / "qwen3_0_6b__decode_32k__single__headshard.json").read_text())
    assert head["unmodelled"] == ["attn_head_constraint"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert head["roofline"][term] == base["roofline"][term]


def test_full_width_cell_ok():
    """Qwen3-0.6B ``train_4k_packed`` on the 16x16 mesh at full width (~2-5 s
    here).  DeepSeek-V3 ``train_4k`` on 2x16x16 takes ~10 s, so it runs in
    ``chip_smoke.py``'s mesh phase and in the by-hand sweep instead."""
    arch, shape, mesh = "qwen3_0_6b", "train_4k_packed", "single"
    rec = dryrun.run_cell(arch, shape, mesh, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == (256 if mesh == "single" else 512)
    assert rec["depth"]["counted_units"] == [1, 2]
    for key in ("bytes_per_device", "bytes_parts", "fits", "parsed_cost", "per_collective", "roofline"):
        assert key in rec
    assert rec["activation_bound"] == "upper, not split over model"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert all(v >= 0 for v in rec["bytes_parts"].values())


def test_flash_dryrun_main_writes_its_record(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.flash_dryrun --device cpu``: rank 0's
    rows of the 16x16 mesh under a fake group, both grids, one JSON file."""
    from repro_torch.launch import flash_dryrun

    monkeypatch.setattr(flash_dryrun, "ARTIFACT_DIR", tmp_path)
    monkeypatch.setattr(sys, "argv", ["flash_dryrun", "--device", "cpu", "--seq", "128", "--json"])
    flash_dryrun.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == json.loads((tmp_path / "flash_sharded.json").read_text())
    assert out["devices"] == 256 and out["rank"] == 0 and out["device"] == "cpu"
    for grid, rec in out["cells"].items():
        assert rec["status"] == "ok" and rec["rows"] == [0, 2] and rec["batch"] == 32
        assert rec["mesh"] == {"data": 16, "model": 16} and rec["loss"] == rec["local_loss"] > 0
