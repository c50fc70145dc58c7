"""The port's meshes, sharding rules, shape cells and ``remat="dots"``
against the JAX package, on the CPU.

The rules are held exactly, leaf by leaf, for all ten architectures at full
width (the JAX tree from ``jax.eval_shape(LM(cfg).init)``, the port's from
``LM(cfg, device="meta")``) on the 16x16 and 2x16x16 production meshes and
on ``make_host_mesh(2)`` and ``make_sim_multihost_mesh(2)`` of 4 ranks,
each built under a fake process group that is destroyed before the test
goes on (``fake_world``).  JAX's ``_param_spec`` and ``_cache_leaf_spec``
read only ``mesh.shape`` and ``mesh.axis_names``, so the JAX side takes a
stand-in with those two fields.  The port's per-layer specs meet JAX's
stacked ones through ``bridge.jax_layout`` (a stacked JAX spec carries a
leading ``None`` for the layer axis).

``remat="dots"``: the policy's choices, the loss and every gradient equal
to ``remat="full"`` bit for bit on every smoke arch, and against JAX's
``remat="dots"`` at ``tests/test_kernels.py::_tol``'s fp32 2e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jax_sharding
from repro.launch import shapes as jax_shapes
from repro.models import LM as JaxLM
from repro_torch.bridge import jax_layout
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import sharding, shapes
from repro_torch.launch.mesh import (
    dp_axes,
    dp_size,
    fake_world,
    make_host_mesh,
    make_production_mesh,
    make_sim_multihost_mesh,
    mesh_shape,
    tp_size,
)
from repro_torch.launch.steps import abstract_caches
from repro_torch.models import LM
from repro_torch.models.blocks import stack_plan
from repro_torch.models.model import _dots_policy
from repro_torch.train import optimizer
from test_torch_archs import (  # noqa: F401  (jax_weights is a fixture)
    TOL,
    _assert_trees_close,
    _batch,
    _pair,
    _port_grads,
    _torch_batch,
    jax_weights,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

MESHES = {
    "single": (256, lambda: make_production_mesh()),
    "multi": (512, lambda: make_production_mesh(multi_pod=True)),
    "host2": (4, lambda: make_host_mesh(2)),
    "sim2": (4, lambda: make_sim_multihost_mesh(2)),
}


@pytest.fixture(scope="module")
def meshes():
    """Each mesh, built under its own fake group (destroyed on the way out:
    a mesh keeps its names and shape)."""
    out = {}
    for name, (world, build) in MESHES.items():
        with fake_world(world):
            out[name] = build()
    return out


def _jax_mesh(mesh):
    return types.SimpleNamespace(shape=mesh_shape(mesh), axis_names=tuple(mesh.mesh_dim_names))


@pytest.fixture(scope="module")
def abstract():
    """Per arch at full width: the JAX params' shapes and the port's meta
    params."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jtree = jax.eval_shape(JaxLM(jax_get_config(arch)).init, jax.random.PRNGKey(0))
            cache[arch] = (jtree, LM(get_config(arch), device="meta").init())
        return cache[arch]

    return get


def _assert_layout_equal(ours: dict, theirs, cfg) -> int:
    """Every JAX spec equals the port's spec at the same place of
    ``jax_layout`` (a stacked leaf is the units' list, each without the
    layer axis).  Returns the JAX leaves compared."""
    layout = jax_layout(ours, cfg)
    leaves = jax.tree_util.tree_flatten_with_path(theirs, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in leaves:
        node = layout
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        if isinstance(node, list):
            assert spec[0] is None, jax.tree_util.keystr(path)
            assert all(s == tuple(spec)[1:] for s in node), (jax.tree_util.keystr(path), node, spec)
        else:
            assert node == tuple(spec), (jax.tree_util.keystr(path), node, spec)
    return len(leaves)


# -- the meshes ------------------------------------------------------------------


def test_meshes(meshes):
    assert mesh_shape(meshes["single"]) == {"data": 16, "model": 16}
    assert mesh_shape(meshes["multi"]) == {"pod": 2, "data": 16, "model": 16}
    assert mesh_shape(meshes["host2"]) == {"data": 2, "model": 2}
    assert mesh_shape(meshes["sim2"]) == {"host": 2, "data": 2, "model": 1}
    assert [dp_axes(meshes[m]) for m in MESHES] == [("data",), ("pod", "data"), ("data",),
                                                    ("host", "data")]
    assert [dp_size(meshes[m]) for m in MESHES] == [16, 32, 2, 4]
    assert [tp_size(meshes[m]) for m in MESHES] == [16, 16, 2, 1]


def test_mesh_needs_its_world():
    with fake_world(8):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh()
        with pytest.raises(ValueError, match="not divisible"):
            make_sim_multihost_mesh(3)
        with pytest.raises(RuntimeError, match="exists already"):
            with fake_world(4):
                pass
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh()


def test_placements_follow_specs(meshes):
    from torch.distributed.tensor import Replicate, Shard

    mesh = meshes["multi"]
    specs = {"a": (("pod", "data"), None), "b": (None, "model"), "c": ("data", "model"), "d": ()}
    pl = sharding.placements(specs, mesh)
    assert pl["a"] == (Shard(0), Shard(0), Replicate())
    assert pl["b"] == (Replicate(), Replicate(), Shard(1))
    assert pl["c"] == (Replicate(), Shard(0), Shard(1))
    assert pl["d"] == (Replicate(),) * 3
    assert {k: sharding.spec_of(v, mesh) for k, v in pl.items()} == {
        "a": (("pod", "data"),), "b": (None, "model"), "c": ("data", "model"), "d": ()}
    assert sharding.local_shape((64, 4096), specs["a"], mesh) == (2, 4096)
    assert sharding.local_shape((32, 4096), specs["c"], mesh) == (2, 256)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_shape((48, 8), specs["a"], mesh)


# -- the rules, exactly ---------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_jax(meshes, abstract, arch, mesh_name):
    mesh = meshes[mesh_name]
    jtree, ours = abstract(arch)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert sharding.use_fsdp(cfg) == jax_sharding.use_fsdp(jcfg)
    pspecs = sharding.param_specs(ours, cfg, mesh)
    jspecs = jax_sharding.param_specs(jtree, jcfg, _jax_mesh(mesh))
    assert _assert_layout_equal(pspecs, jspecs, cfg) == len(jax.tree.leaves(jtree))
    ospecs = sharding.opt_state_specs(None, pspecs)
    jo = jax_sharding.opt_state_specs(None, jspecs)
    for key in ("m", "v"):
        _assert_layout_equal(ospecs[key], jo[key], cfg)
    assert ospecs["step"] == tuple(jo["step"]) == ()


def _cache_cells(cfg):
    return [name for name in ("decode_32k", "long_500k") if shapes.applicability(cfg, name)[0]]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).has_decode])
def test_cache_specs_match_jax(meshes, arch, mesh_name):
    mesh = meshes[mesh_name]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    plan = stack_plan(cfg)
    for name in _cache_cells(cfg):
        cell = shapes.SHAPES[name]
        caches = abstract_caches(LM(cfg, device="meta"), cell.global_batch, cell.seq_len)
        ours = sharding.cache_specs(caches, cfg, mesh)
        jcaches = jax.eval_shape(lambda: JaxLM(jcfg).init_caches(cell.global_batch, cell.seq_len))
        theirs = jax_sharding.cache_specs(jcaches, jcfg, _jax_mesh(mesh))
        pairs = [(ours[l], theirs["prefix"][i]["sub0"], False) for i, l in enumerate(plan.prefix_layers)]
        pairs += [(ours[unit[j]], theirs["stack"][f"sub{j}"], True)
                  for unit in plan.unit_layers for j in range(len(unit))]
        assert len(pairs) == cfg.n_layers
        for mine, jax_cache, stacked in pairs:
            assert type(mine).__name__ == type(jax_cache).__name__ and mine._fields == jax_cache._fields
            for field, spec, jspec in zip(mine._fields, mine, jax_cache):
                want = tuple(jspec)[1:] if stacked else tuple(jspec)
                assert spec == want, (name, field, spec, jspec)
        # the stand-ins hold JAX's elements, in its dtypes
        jleaves = jax.tree.leaves(jcaches)
        assert sum(int(np.prod(x.shape)) for x in jleaves) == sum(t.numel() for c in caches for t in c)
        assert {np.dtype(x.dtype).name for x in jleaves} == {
            str(t.dtype).removeprefix("torch.") for c in caches for t in c}


def test_batch_specs_match_jax(meshes):
    """The simulated multi-host mesh of tests/test_multihost.py ("host" 2,
    "data" 2, "model" 1), and every mesh on the train cells' batches."""
    mesh = meshes["sim2"]
    for rows in (1, 2, 3, 4, 6, 8, 12):
        batch = {"tokens": torch.empty((rows, 96), dtype=torch.int32, device="meta"),
                 "embeds": torch.empty((rows, 96, 8), device="meta")}
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in batch.items()}
        theirs = jax_sharding.batch_specs(jbatch, _jax_mesh(mesh))
        assert sharding.batch_specs(batch, mesh) == {k: tuple(v) for k, v in theirs.items()}
        assert sharding.batch_dp_axes(rows, mesh) == jax_sharding.batch_dp_axes(rows, _jax_mesh(mesh))
    for mesh_name, mesh in meshes.items():
        for name in ("train_4k", "train_4k_packed"):
            batch = shapes.train_batch_specs(get_config("qwen3_0_6b"), shapes.SHAPES[name])
            jbatch = jax_shapes.train_batch_specs(jax_get_config("qwen3_0_6b"), jax_shapes.SHAPES[name])
            theirs = jax_sharding.batch_specs(jbatch, _jax_mesh(mesh))
            assert sharding.batch_specs(batch, mesh) == {k: tuple(v) for k, v in theirs.items()}


# -- the shape cells, exactly -------------------------------------------------------


def _same_struct(t: torch.Tensor, s) -> bool:
    return tuple(t.shape) == tuple(s.shape) and str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name


def test_shape_cells_match_jax():
    assert shapes.SHAPE_ORDER == jax_shapes.SHAPE_ORDER
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    assert {k: dataclasses.asdict(v) for k, v in shapes.SERVE_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_shapes.SERVE_SHAPES.items()}
    for cell in shapes.SERVE_SHAPES.values():
        jcell = jax_shapes.SERVE_SHAPES[cell.name]
        assert all(map(_same_struct, shapes.serve_decode_specs(cell), jax_shapes.serve_decode_specs(jcell)))
        assert all(map(_same_struct, shapes.serve_prefill_specs(3, 128, cell.num_slots),
                       jax_shapes.serve_prefill_specs(3, 128, jcell.num_slots)))
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name in shapes.SHAPE_ORDER:
            assert shapes.applicability(cfg, name) == jax_shapes.applicability(jcfg, name), (arch, name)
            cell, jcell = shapes.SHAPES[name], jax_shapes.SHAPES[name]
            if cell.kind == "train":
                ours = shapes.train_batch_specs(cfg, cell)
                theirs = jax_shapes.train_batch_specs(jcfg, jcell)
                assert list(ours) == list(theirs)
                assert all(_same_struct(ours[k], theirs[k]) for k in ours), (arch, name)
                assert all(t.device.type == "meta" for t in ours.values())
            elif cell.kind == "prefill":
                assert _same_struct(shapes.prefill_token_specs(cfg, cell),
                                    jax_shapes.prefill_token_specs(jcfg, jcell))
            else:
                assert _same_struct(shapes.decode_token_specs(cell), jax_shapes.decode_token_specs(jcell))


# -- remat="dots" ---------------------------------------------------------------------


def test_dots_policy_saves_products_without_batch():
    aten = torch.ops.aten
    m = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    save, again = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert _dots_policy(None, aten.mm.default, m(4, 8), m(8, 3)) == save
    assert _dots_policy(None, aten.addmm.default, m(3), m(4, 8), m(8, 3)) == save
    assert _dots_policy(None, aten.bmm.default, m(1, 4, 8), m(1, 8, 3)) == save
    assert _dots_policy(None, aten.bmm.default, m(2, 4, 8), m(2, 8, 3)) == again
    for op in (aten.add.Tensor, aten.mul.Tensor, aten._softmax.default, aten.index.Tensor):
        assert _dots_policy(None, op, m(2, 4), m(2, 4)) == again


class _Products(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n["mm"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.n["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(arch: str, remat: str, counter=None):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg, seed=6))
    loss_sum, tokens = model.loss_sums(params, batch)
    loss = loss_sum / tokens
    leaves = optimizer.tree_leaves(params)
    if counter is None:
        return loss.detach(), torch.autograd.grad(loss, leaves)
    with counter:
        return loss.detach(), torch.autograd.grad(loss, leaves)


def test_dots_recomputes_batched_products_only():
    """In the backward, "dots" runs the matrix products of "none" (no
    product without a batch dimension is recomputed) and the batched ones
    of "full" (the attention scores are)."""
    counts = {}
    for remat in ("none", "full", "dots"):
        counter = _Products()
        _loss_and_grads("qwen3_0_6b", remat, counter)
        counts[remat] = counter.n
    assert counts["full"]["mm"] > counts["none"]["mm"] == counts["dots"]["mm"]
    assert counts["full"]["bmm"] == counts["dots"]["bmm"] > counts["none"]["bmm"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dots_equals_full_bitwise(arch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the embedding's index backward accumulates in parallel
    try:
        full_loss, full = _loss_and_grads(arch, "full")
        dots_loss, dots = _loss_and_grads(arch, "dots")
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(full_loss, dots_loss)
    assert all(torch.equal(a, b) for a, b in zip(full, dots))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_130m"])
def test_dots_matches_jax(arch):
    from repro.configs import get_smoke_config as jax_smoke_config

    jcfg = dataclasses.replace(jax_smoke_config(arch), remat="dots")
    np_params = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    jmodel, model, params = _pair(lambda _: np_params, arch, remat="dots")
    assert model.cfg.remat == jmodel.cfg.remat == "dots" and model.cfg.dtype == "float32"
    batch = _batch(model.cfg, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jnp.divide(*jmodel.loss_sums(p, jbatch))))(
        jax.tree.map(jnp.asarray, np_params))
    tsum, ttok, tgrads = _port_grads(model, params, batch)
    np.testing.assert_allclose(float(tsum.detach() / ttok), float(jloss), **TOL)
    _assert_trees_close(tgrads, jgrads, **TOL)
