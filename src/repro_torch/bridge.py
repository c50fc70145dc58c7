"""Weights between the JAX package's parameter tree and the port's.

``params_from_jax`` takes the pytree that the JAX ``LM.init`` returns, as
numpy arrays (``jax.tree.map(np.asarray, params)``); ``params_to_jax`` is its
inverse, for comparing trained weights leaf by leaf (as fp32 numpy).  Its
dtype-keeping twin ``jax_layout`` arranges the port's own tensors in the JAX
tree's layout without copying them, which the checkpoints use to write and
restore a state under the JAX package's keys.  None imports JAX.
The JAX stack stores every layer of a scanned unit stacked on a leading axis
(``params["stack"]["sub{j}"]``); the port keeps one entry per layer, so that
axis is unstacked (and restacked) in layer order.  Projections keep the
``(d_in, d_out)`` layout on both sides.  Leaves keep their dtypes: an SSM
layer's mixer (``in_z, in_x, in_b, in_c, in_dt, conv_w, dt_bias, a_log,
d_skip, out_norm, out_proj``) has fp32 ``a_log``, ``dt_bias`` and ``d_skip``
beside projections in the model dtype, and no FFN group; an MoE layer's
``moe`` group has an fp32 ``router`` beside ``(E, d, ff)`` / ``(E, ff, d)``
expert slabs (and a ``shared`` group with a shared expert).  A model fed
input embeddings has no ``embed``, a non-parametric norm is an empty group,
and a unit of ``moe_every`` layers, or of one hybrid period (Jamba: an
attention layer among Mamba-2 layers, MoE and dense FFNs alternating), holds
them as ``sub0``, ``sub1``, ….  Leading dense layers (DeepSeek-V3's
``first_k_dense``) are not stacked: the JAX tree keeps them as the list
``prefix`` of one-layer units, ``prefix[i]["sub0"]`` being layer i.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import stack_plan


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (JAX's buffers are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    """``fn`` over the leaves of a tree of dicts and lists of dicts (a list
    of tensors, a stacked leaf of ``jax_layout``, is one leaf)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(np_params: dict, cfg, device=None, mesh=None) -> dict:
    """The port's tree (see ``repro_torch.models.model``) from JAX params;
    with a ``mesh`` whose ``model`` axis is larger than 1, this rank's tree
    for expert parallelism (``launch.sharding.local_moe_params``), cut
    before anything is copied."""
    from repro_torch.launch.sharding import local_moe_params

    device = resolve_device(device)
    plan = stack_plan(cfg)
    layers: list = [None] * cfg.n_layers
    for i, layer_idx in enumerate(plan.prefix_layers):
        layers[layer_idx] = np_params["prefix"][i]["sub0"]
    for u, unit in enumerate(plan.unit_layers):
        for j, layer_idx in enumerate(unit):
            layers[layer_idx] = _map(np_params["stack"][f"sub{j}"], lambda a: np.asarray(a)[u])
    tree = {"embed": np_params["embed"]} if "embed" in np_params else {}
    tree.update(unembed=np_params["unembed"], final_norm=np_params["final_norm"], layers=layers)
    tree = local_moe_params(tree, cfg, mesh)
    return _map(tree, lambda a: _tensor(a, device))


def _array(t: torch.Tensor) -> np.ndarray:
    """fp32 numpy copy of a tensor (bf16 upcasts exactly; numpy has no bf16)."""
    return t.detach().float().cpu().numpy()


def jax_layout(tree: dict, cfg) -> dict:
    """A port tree (the weights, or an optimizer moment of the same shape)
    in the JAX tree's layout, with the port's own tensors as leaves: a leaf
    under ``stack/sub{j}`` is the list of the units' tensors, in unit order,
    that the JAX package stacks on a leading axis; ``prefix`` (when the plan
    has one) is the list of ``{"sub0": layer}`` units, unstacked."""
    plan = stack_plan(cfg)
    stack = {}
    for j in range(len(plan.unit_layers[0])):
        stack[f"sub{j}"] = _zip([tree["layers"][unit[j]] for unit in plan.unit_layers])
    out = {"embed": tree["embed"]} if "embed" in tree else {}
    out.update(unembed=tree["unembed"], final_norm=tree["final_norm"])
    if plan.prefix_layers:
        out["prefix"] = [{"sub0": tree["layers"][l]} for l in plan.prefix_layers]
    out["stack"] = stack
    return out


def _zip(trees: list):
    if isinstance(trees[0], dict):
        return {k: _zip([t[k] for t in trees]) for k in trees[0]}
    return trees


def params_to_jax(params: dict, cfg, mesh=None) -> dict:
    """The JAX-layout tree, as fp32 numpy arrays, from the port's tree: every
    unit's layers stacked on a leading axis under ``stack/sub{j}``, the
    prefix layers under ``prefix[i]["sub0"]``.  With a ``mesh`` whose
    ``model`` axis is larger than 1, ``params`` is this rank's tree and the
    MoE shards are gathered over the axis first (a collective: every rank
    of the group calls it)."""
    from repro_torch.launch.sharding import gather_moe_params

    params = gather_moe_params(params, cfg, mesh)
    return _map(jax_layout(params, cfg), lambda leaf: (
        np.stack([_array(t) for t in leaf]) if isinstance(leaf, list) else _array(leaf)))
