"""Weights between the JAX package's parameter tree and the port's.

``params_from_jax`` takes the pytree that the JAX ``LM.init`` returns, as
numpy arrays (``jax.tree.map(np.asarray, params)``); ``params_to_jax`` is its
inverse, for comparing trained weights leaf by leaf.  Neither imports JAX.
The JAX stack stores every layer of a scanned unit stacked on a leading axis
(``params["stack"]["sub{j}"]``); the port keeps one entry per layer, so that
axis is unstacked (and restacked) in layer order.  Projections keep the
``(d_in, d_out)`` layout on both sides.
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
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: dict, cfg, device=None) -> dict:
    """The port's tree (see ``repro_torch.models.model``) from JAX params."""
    device = resolve_device(device)
    plan = stack_plan(cfg)
    if "prefix" in np_params:
        raise NotImplementedError("stacks with a prefix of other layers are not ported yet")
    layers: list = [None] * cfg.n_layers
    for u, unit in enumerate(plan.unit_layers):
        for j, layer_idx in enumerate(unit):
            layers[layer_idx] = _map(np_params["stack"][f"sub{j}"], lambda a: _tensor(a[u], device))
    return {
        "embed": _tensor(np_params["embed"], device),
        "unembed": _tensor(np_params["unembed"], device),
        "final_norm": _map(np_params["final_norm"], lambda a: _tensor(a, device)),
        "layers": layers,
    }


def _array(t: torch.Tensor) -> np.ndarray:
    """fp32 numpy copy of a tensor (bf16 upcasts exactly; numpy has no bf16)."""
    return t.detach().float().cpu().numpy()


def params_to_jax(params: dict, cfg) -> dict:
    """The JAX-layout tree, as fp32 numpy arrays, from the port's tree: every
    unit's layers stacked on a leading axis under ``stack/sub{j}``."""
    plan = stack_plan(cfg)
    stack = {}
    for j in range(len(plan.unit_layers[0])):
        per_unit = [params["layers"][unit[j]] for unit in plan.unit_layers]
        stack[f"sub{j}"] = _stack([_map(layer, _array) for layer in per_unit])
    return {
        "embed": _array(params["embed"]),
        "unembed": _array(params["unembed"]),
        "final_norm": _map(params["final_norm"], _array),
        "stack": stack,
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
