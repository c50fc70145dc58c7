"""Sharding rules: logical roles -> per-dimension mesh axes (the JAX
package's rules, unchanged).

A spec is a tuple with one entry per tensor dimension: ``None``, an axis
name, or a tuple of axis names, as in a JAX ``PartitionSpec``.
:func:`placements` turns it into DTensor placements over a
``DeviceMesh``.

Conventions:
  * ``model`` axis: TP (attention heads / FFN hidden / vocab) and EP
    (expert slabs).
  * ``data`` axis: DP for activations; FSDP storage axis for the weights of
    archs above ``FSDP_THRESHOLD``.
  * ``pod`` axis: pure DP, weights replicated across pods so weight gathers
    never cross pods; only gradient reduction does.
  * ``host`` axis (the simulated multi-host lane): outer pure-DP axis;
    ``dp_axes`` folds it into the batch partition.
  * Inputs must divide evenly: every rule checks divisibility and falls
    back to replication.

Cache layout (small-kv archs, kv=8 < TP=16): shard the head_dim (128/16)
instead of the kv-head dim; MLA latent caches are replicated over ``model``.

The port's tree holds one entry per layer (``bridge.py``), so the rules see
a per-layer leaf and never the JAX stack's leading layer axis; the bridge's
``jax_layout`` maps the port's specs onto the JAX tree.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.launch.mesh import dp_axes, mesh_shape

Spec = tuple


def _div(n: int, shape: dict, axes) -> bool:
    if isinstance(axes, str):
        axes = (axes,)
    size = math.prod(shape[a] for a in axes)
    return size > 0 and n % size == 0


FSDP_THRESHOLD = 8e9  # params; above this, weights store FSDP over `data`


def use_fsdp(cfg) -> bool:
    return cfg.param_count() > FSDP_THRESHOLD


# -----------------------------------------------------------------------------
# Trees of dicts, lists and named tuples whose leaves are tensors or specs
# -----------------------------------------------------------------------------


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path_keys, leaf)`` over a tree of dicts, lists and named tuples;
    a plain tuple is a leaf (a spec), and so is ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(list(path), tree)


def tree_leaves_with_path(tree) -> list[tuple[list[str], Any]]:
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


# -----------------------------------------------------------------------------
# Parameter specs
# -----------------------------------------------------------------------------

_REPLICATED_KEYS = {
    "scale", "q_norm", "k_norm", "kv_norm", "out_norm", "dt_bias", "a_log",
    "d_skip", "conv_w", "router",
}
_COL_PARALLEL = {"wq", "wk", "wv", "w_uq", "in_z", "in_x"}  # (d_in, tp_out)
_ROW_PARALLEL = {"wo", "out_proj"}  # (tp_in, d_out)
_LATENT_DOWN = {"w_dq", "w_dkv", "in_b", "in_c", "in_dt"}  # (d_in, small)
_LATENT_UP = {"w_uk", "w_uv"}  # (latent, tp_out)


def _param_spec(path_keys: list[str], shape: tuple[int, ...], mesh, fsdp: bool) -> Spec:
    name = path_keys[-1]
    axes = mesh_shape(mesh)
    f = "data" if (fsdp and "data" in axes) else None

    def fx(dim: int):
        return f if (f and _div(dim, axes, f)) else None

    def tp(dim: int):
        return "model" if "model" in axes and _div(dim, axes, "model") else None

    nd = len(shape)
    if name in _REPLICATED_KEYS or nd <= 1:
        return (None,) * nd
    if name == "embed":
        return (tp(shape[0]), fx(shape[1]))
    if name == "unembed":
        return (fx(shape[0]), tp(shape[1]))
    if nd == 3 and name in ("w_in", "w_gate"):  # expert slab (E, d, ff)
        return (tp(shape[0]), fx(shape[1]), None)
    if nd == 3 and name == "w_out":  # expert slab (E, ff, d)
        return (tp(shape[0]), None, fx(shape[2]))
    if name in ("w_in", "w_gate") or name in _COL_PARALLEL:  # (d, ff) / (d_in, tp_out)
        return (fx(shape[0]), tp(shape[1]))
    if name == "w_out" or name in _ROW_PARALLEL:  # (ff, d) / (tp_in, d_out)
        return (tp(shape[0]), fx(shape[1]))
    if name in _LATENT_DOWN:
        return (fx(shape[0]), None)
    if name in _LATENT_UP:
        return (None, tp(shape[1]))
    return (None,) * nd


def param_specs(params_tree, cfg, mesh):
    """Spec tree matching ``params_tree`` (tensors, meta ones included)."""
    fsdp = use_fsdp(cfg)
    return tree_map_with_path(lambda path, leaf: _param_spec(path, tuple(leaf.shape), mesh, fsdp),
                              params_tree)


def opt_state_specs(opt_shapes, param_spec_tree):
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}


# -----------------------------------------------------------------------------
# Batch / cache specs
# -----------------------------------------------------------------------------


def batch_dp_axes(global_batch: int, mesh):
    """Largest prefix of the DP axes that divides the batch evenly."""
    shape = mesh_shape(mesh)
    axes = []
    size = 1
    for a in dp_axes(mesh):
        if global_batch % (size * shape[a]) == 0:
            axes.append(a)
            size *= shape[a]
    return tuple(axes) if axes else None


def _entry(axes):
    """A spec entry for ``axes``: one name stands alone (JAX's
    ``PartitionSpec`` normalises ``("data",)`` to ``"data"``)."""
    return axes[0] if axes and len(axes) == 1 else axes


def batch_specs(batch_tree, mesh):
    def spec(path, leaf):
        return (_entry(batch_dp_axes(leaf.shape[0], mesh)),) + (None,) * (len(leaf.shape) - 1)

    return tree_map_with_path(spec, batch_tree)


def _cache_leaf_spec(path_keys: list[str], shape, cfg, mesh) -> Spec:
    """Specs for KV / MLA / SSM cache leaves (named tuple fields)."""
    axes = mesh_shape(mesh)
    name = path_keys[-1]
    dp = _entry(batch_dp_axes(shape[0], mesh))

    def tp(dim: int):
        return "model" if "model" in axes and _div(dim, axes, "model") else None

    if name in ("k", "v"):  # (B, S, kv, dh)
        if tp(shape[2]):
            return (dp, None, "model", None)
        if tp(shape[3]):
            return (dp, None, None, "model")  # head-dim sharding (kv < TP)
        return (dp, None, None, None)
    if name == "state":  # SSM (B, H, P, N)
        return (dp, tp(shape[1]), None, None)
    if name == "conv":  # (B, k, channels)
        return (dp, None, tp(shape[2]))
    return (dp,) + (None,) * (len(shape) - 1)  # MLA latents and the rest


def cache_specs(cache_shapes, cfg, mesh):
    return tree_map_with_path(
        lambda path, leaf: _cache_leaf_spec(path, tuple(leaf.shape), cfg, mesh), cache_shapes
    )


# -----------------------------------------------------------------------------
# Specs on a DeviceMesh
# -----------------------------------------------------------------------------


def spec_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(tree_specs, mesh):
    """DTensor placements (a tuple, one per mesh dimension) for every spec
    in the tree: ``Shard(d)`` on each mesh dimension that shards tensor dimension
    ``d``, ``Replicate()`` elsewhere.  A dimension sharded over
    ``("pod", "data")`` is ``Shard(d)`` on both mesh dimensions; DTensor
    splits a tensor dimension over its mesh dimensions in mesh order, outer
    first, which is the order in which JAX's ``PartitionSpec(("pod",
    "data"))`` lays the shards out (pod-major), because the names stand in
    mesh order here."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names

    def one(path, spec):
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            for a in spec_axes(entry):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    return tree_map_with_path(one, tree_specs)


def spec_of(placement_list, mesh) -> Spec:
    """The spec that :func:`placements` made ``placement_list`` from (an
    axis entry with one name reads as that name)."""
    dims: dict[int, list[str]] = {}
    for name, p in zip(mesh.mesh_dim_names, placement_list):
        if p.is_shard():
            dims.setdefault(p.dim, []).append(name)
    nd = max(dims, default=-1) + 1
    return tuple(None if d not in dims else dims[d][0] if len(dims[d]) == 1 else tuple(dims[d])
                 for d in range(nd))


def local_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape one rank holds of a tensor of ``shape`` laid out by ``spec``."""
    axes = mesh_shape(mesh)
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for n, entry in zip(shape, spec):
        parts = math.prod(axes[a] for a in spec_axes(entry))
        if n % parts:
            raise ValueError(f"dimension {n} does not divide over {entry} ({parts} parts)")
        out.append(n // parts)
    return tuple(out)


# -----------------------------------------------------------------------------
# The executed EP path: one rank's MoE shard of a full tree, and back
# -----------------------------------------------------------------------------

# Which dimension of an MoE layer's leaf the ``model`` axis cuts: the expert
# slabs by expert, the shared expert and the dense residual as TP MLPs (the
# JAX package's ``shared_specs`` / ``dense_specs`` in ``models/moe.py``).
_EP_CUT = {("moe", "w_in"): 0, ("moe", "w_gate"): 0, ("moe", "w_out"): 0,
           ("shared", "w_in"): 1, ("shared", "w_gate"): 1, ("shared", "w_out"): 0}
_DENSE_CUT = {("mlp", "w_in"): 1, ("mlp", "w_gate"): 1, ("mlp", "w_out"): 0}


def _moe_cut_dim(cfg, layer: int, path: list[str]):
    """The dimension the ``model`` axis cuts for a layer leaf on the EP
    path, or None for a leaf every rank holds whole."""
    if not cfg.layer_is_moe(layer):
        return None
    key = tuple(path[-2:])
    if key in _EP_CUT:
        return _EP_CUT[key]
    if cfg.dense_residual and key in _DENSE_CUT:
        return _DENSE_CUT[key]
    return None


def _ep_coords(cfg, mesh):
    """``(group, ep, index)`` on the ``model`` axis, None when the MoE takes
    the single-device branch; raises when ``ep`` divides a width unevenly."""
    from repro_torch.models.moe import ep_widths, model_axis

    axis = model_axis(mesh)
    if axis is not None:
        ep_widths(cfg, axis[1])
    return axis


def _map_layers(params: dict, fn) -> dict:
    """``fn(layer_index, path, leaf)`` over the layer leaves; the other
    leaves are kept as they are."""
    out = dict(params)
    out["layers"] = [tree_map_with_path(lambda path, leaf, l=l: fn(l, path, leaf), layer)
                     for l, layer in enumerate(params["layers"])]
    return out


def moe_shard(params: dict, cfg, ep: int, index: int) -> dict:
    """The tree rank ``index`` of an EP axis of ``ep`` holds: of every MoE
    layer the expert slabs ``[index · E/ep, (index + 1) · E/ep)`` and the
    shared expert's and the dense residual's TP slices (``w_in``/``w_gate``
    by columns, ``w_out`` by rows); every other leaf whole.  The leaves are
    views of ``params`` (numpy arrays or tensors)."""

    def cut(l, path, leaf):
        dim = _moe_cut_dim(cfg, l, path)
        if dim is None:
            return leaf
        n = leaf.shape[dim] // ep
        sl = [slice(None)] * len(leaf.shape)
        sl[dim] = slice(index * n, (index + 1) * n)
        return leaf[tuple(sl)]

    return _map_layers(params, cut)


def local_moe_params(params: dict, cfg, mesh) -> dict:
    """This rank's tree for the executed EP path (``models/moe.py``): its
    :func:`moe_shard` on the mesh's ``model`` axis.

    The eager port runs the rest of the model replicated over ``model``:
    the same function on every rank, not GSPMD's placement of the JAX
    rules above.  Without an EP axis (no mesh, no ``model`` axis, or one of
    size 1) the tree comes back as it is."""
    axis = _ep_coords(cfg, mesh)
    if axis is None:
        return params
    _, ep, index = axis
    return moe_shard(params, cfg, ep, index)


def gather_moe_params(local: dict, cfg, mesh) -> dict:
    """The inverse of :func:`local_moe_params`: every rank of a ``model``
    group passes its tree (weights or their gradients) and gets the full
    tree back, the cut leaves gathered over the group in rank order and
    the others as they are.  A collective: every rank must call it."""
    import torch
    import torch.distributed as dist

    axis = _ep_coords(cfg, mesh)
    if axis is None:
        return local
    group, ep, _ = axis

    def gather(l, path, leaf):
        dim = _moe_cut_dim(cfg, l, path)
        if dim is None:
            return leaf
        leaf = leaf.detach().contiguous()
        parts = [torch.empty_like(leaf) for _ in range(ep)]
        dist.all_gather(parts, leaf, group=group)
        return torch.cat(parts, dim=dim)

    return _map_layers(local, gather)
