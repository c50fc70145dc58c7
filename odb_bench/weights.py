"""The weights of a run, made by the benchmark from the seed on the device.

The port's parameter tree gives the leaves' paths, shapes and dtypes; the
values are the benchmark's own: one call draws a standard normal for every
random leaf at once (clipped at ±2), which is then cut into the leaves:
matrices scaled by 1/√d_in (the first axis: leaves are stored (d_in,
d_out)), conv weights by 0.1; norm scales and D at 1, dt_bias at 0, A_log
at log(linspace(1, 16, heads)).  The same seed gives the same tensors, so
the reference regenerates them instead of keeping a copy.
"""

from __future__ import annotations

import math

import torch

ONES = ("scale", "q_norm", "k_norm", "out_norm", "d_skip")


def flatten(tree, prefix=()) -> list:
    """(path, leaf) pairs: dict keys sorted, lists in order (the order the
    port's optimizer visits its leaves)."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree) for pair in flatten(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, item in enumerate(tree) for pair in flatten(item, prefix + (i,))]
    return [(prefix, tree)]


def unflatten(pairs) -> dict:
    """The nested tree of (path, leaf) pairs (integer keys become lists)."""
    root: dict = {}
    for path, leaf in pairs:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def kind(path, shape) -> str:
    name = path[-1]
    if name in ONES:
        return "ones"
    if name == "dt_bias":
        return "zeros"
    if name == "a_log":
        return "a_log"
    if name == "conv_w":
        return "conv"
    if len(shape) == 2:
        return "dense"
    raise ValueError(f"no initialisation rule for leaf {'/'.join(map(str, path))} {tuple(shape)}")


def make(specs, seed: int, device) -> list:
    """Tensors for ``specs`` = [(path, shape, dtype)], from ``seed``."""
    random_numel = sum(math.prod(s) for p, s, _ in specs if kind(p, s) in ("dense", "conv"))
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(random_numel, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = [], 0
    for path, shape, dtype in specs:
        k = kind(path, shape)
        if k in ("dense", "conv"):
            n = math.prod(shape)
            scale = 0.1 if k == "conv" else 1.0 / math.sqrt(shape[0])
            out.append((buf[at:at + n].view(shape) * scale).to(dtype))
            at += n
        elif k == "ones":
            out.append(torch.ones(shape, dtype=dtype, device=device))
        elif k == "zeros":
            out.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            out.append(torch.log(torch.linspace(1.0, 16.0, shape[0], device=device)).to(dtype))
    del buf
    return out
