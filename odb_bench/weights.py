"""The weights of a run, made by the benchmark from the seed on the device.

The port's parameter tree gives the leaves' paths, shapes and dtypes; the
values are the benchmark's own: one call draws a standard normal for every
random leaf at once (clipped at ±2), which is then cut into the leaves
in leaf order: matrices, stored (d_in, d_out), scaled by 1/√d_in; expert
slabs (E, d_in, d_out) as E such matrices, each its own slice of the draw,
so that no two experts are alike and a token sent to the wrong one
changes the result; conv weights by 0.1.  Norm scales (any 1-D leaf whose name ends in
``norm``) and D at 1, biases (1-D, ending in ``bias``) at 0, A_log at
log(linspace(1, 16, heads)).  A leaf that no rule names raises.  The same
seed gives the same tensors.
"""

from __future__ import annotations

import math

import torch

ONES = ("scale", "q_norm", "k_norm", "out_norm", "d_skip")
RANDOM = ("dense", "experts", "conv")  # the kinds cut from the seeded draw


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
    if len(shape) == 3:
        return "experts"
    if len(shape) == 1 and name.endswith("norm"):
        return "ones"
    if len(shape) == 1 and name.endswith("bias"):
        return "zeros"
    raise ValueError(f"no initialisation rule for leaf {'/'.join(map(str, path))} {tuple(shape)}")


def host_like(tensors, pin: bool) -> list:
    """Empty host tensors shaped and typed like ``tensors``, views of one
    buffer, page-locked where ``pin``: a card's copies to and from it run
    several times faster than to fresh pageable memory, and one block is
    locked, not one a tensor (the pinned allocator rounds each block up to
    a power of two)."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    flat = torch.empty(sum(-(-n // 16) * 16 for n in sizes), dtype=torch.uint8, pin_memory=pin)
    out, at = [], 0
    for t, n in zip(tensors, sizes):
        out.append(flat[at:at + n].view(t.dtype).view(t.shape))
        at += -(-n // 16) * 16  # each view 16-byte aligned
    return out


def make(specs, seed: int, device) -> list:
    """Tensors for ``specs`` = [(path, shape, dtype)], from ``seed``."""
    random_numel = sum(math.prod(s) for p, s, _ in specs if kind(p, s) in RANDOM)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(random_numel, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = [], 0
    for path, shape, dtype in specs:
        k = kind(path, shape)
        if k in RANDOM:
            n = math.prod(shape)
            scale = 0.1 if k == "conv" else 1.0 / math.sqrt(shape[-2])
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
