"""Multi-tensor AdamW with global-norm clipping: the wrapper over the CUDA kernels.

``csrc/adamw.cu`` holds three kernels, launched on the current stream with
no host sync:

* ``adamw_sqnorm`` — the clip's sum of squares of every gradient leaf, one
  fp32 partial a block (a block is a chunk of :data:`CHUNK` elements of one
  leaf);
* ``adamw_finish`` — one block: the partials summed in a fixed order, the
  pre-clip norm, the clip scale, the step counter + 1 (in place), the cosine
  learning rate and the bias corrections, into device scalars;
* ``adamw_update`` — one read of p, g, m and v and one write of p, m and v
  per element, the arithmetic in fp32 registers.

:func:`plan` is the host's chunk table: the leaves with elements, grouped by
their dtypes (one launch a group and pass) and cut into launches of at most
:data:`MAX_LEAVES` leaves, whose table travels as the launch's parameters,
with each leaf's first block.  A step makes ``2 · len(plan) + 1`` launches:
9 for Qwen3-0.6B's 311 leaves.  Each adds one to its entry in
:data:`LAUNCHES` and to the registry counter ``kernel_adamw_launches_total``.

:func:`adamw_step` takes the flat leaves of one CUDA device and launches or
raises (a non-contiguous leaf, a dtype other than float32 or bfloat16,
devices or shapes that differ); there is no fallback.  Its plain version is
``train/optimizer.adamw_update_plain``, which ``adamw_update`` takes for CPU
and meta leaves.  Given the same norm, the kernel's parameters and moments
equal the plain version's bit for bit (``csrc/adamw.cu``).  The kernel
writes through raw pointers, so the tensors' autograd version counters do
not move.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.build import launch, load_library

CHUNK = 1 << 16  # elements a block
MAX_LEAVES = 80  # a launch's table: 48 B a leaf, under the 4 KB of kernel parameters
SCALARS = ("grad_norm", "lr", "scale", "bc1", "bc2")  # the finish kernel's outputs, in order

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"adamw_sqnorm": 0, "adamw_finish": 0, "adamw_update": 0}
_COUNTER = ("kernel_adamw_launches_total", "launches of the multi-tensor AdamW kernels")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["CHUNK", "LAUNCHES", "MAX_LEAVES", "Launch", "adamw_step", "plan", "reset_launches"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of each pass: its dtype group, its leaves (indices into
    the list given to :func:`plan`), each leaf's first block, and its
    blocks."""

    key: object
    leaves: tuple[int, ...]
    chunk0: tuple[int, ...]
    blocks: int


def plan(numels, keys=None, chunk: int = CHUNK, max_leaves: int = MAX_LEAVES) -> list[Launch]:
    """The launches over leaves of ``numels`` elements, grouped by ``keys``
    (groups in order of first appearance, leaves in order within a group).
    Leaf ``i`` of a launch takes blocks ``chunk0[i]`` to
    ``chunk0[i] + ceil(numel / chunk) - 1``; block ``k`` of them covers
    elements ``[k · chunk, min((k + 1) · chunk, numel))``.  A leaf with no
    elements takes no block and no launch."""
    keys = [None] * len(numels) if keys is None else keys
    groups: dict = {}
    for i, (n, key) in enumerate(zip(numels, keys, strict=True)):
        if n:
            groups.setdefault(key, []).append(i)
    launches = []
    for key, leaves in groups.items():
        for lo in range(0, len(leaves), max_leaves):
            part = tuple(leaves[lo:lo + max_leaves])
            firsts, blocks = [], 0
            for i in part:
                firsts.append(blocks)
                blocks += -(-numels[i] // chunk)
            if blocks >= 1 << 31:
                raise ValueError(f"a launch of {blocks} blocks of {chunk} elements is past the grid's limit")
            launches.append(Launch(key, part, tuple(firsts), blocks))
    return launches


def _hyper(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The finish and update kernels' constants, rounded to fp32 as the
    plain version's scalars are (``cosine_lr``, ``adamw_update_plain``)."""
    f32 = np.float32
    warmup = f32(max(cfg.warmup_ratio * cfg.total_steps, 1.0))
    span = max(f32(float(cfg.total_steps)) - warmup, f32(1.0))
    b1, b2 = cfg.betas
    finish = np.array([cfg.grad_clip, cfg.lr, warmup, span, cfg.min_lr_fraction,
                       (1 - cfg.min_lr_fraction) * 0.5, math.pi, b1, b2], f32)
    update = np.array([b1, 1 - b1, b2, 1 - b2, cfg.eps, cfg.weight_decay], f32)
    return finish, update


def _check(params, grads, m, v, step) -> None:
    if not len(params) == len(grads) == len(m) == len(v):
        raise ValueError("params, grads and both moments must have the same leaves")
    device = step.device
    if device.type != "cuda" or step.dtype != torch.int32 or step.numel() != 1:
        raise ValueError("the step counter must be one int32 on the CUDA device")
    for leaf in zip(params, grads, m, v):
        p, g, mm, vv = leaf
        if any(t.device != device for t in leaf):
            raise ValueError(f"the AdamW kernel's tensors must lie on one device, {device}")
        if not all(t.is_contiguous() for t in leaf):
            raise ValueError("the AdamW kernel takes contiguous tensors")
        if not (p.dtype in _DTYPES and g.dtype in _DTYPES and mm.dtype in _DTYPES and vv.dtype == mm.dtype):
            raise TypeError(f"the AdamW kernel takes float32 or bfloat16 (moments of one dtype), got "
                            f"{p.dtype}, {g.dtype}, {mm.dtype}, {vv.dtype}")
        if not p.shape == g.shape == mm.shape == vv.shape:
            raise ValueError(f"shapes differ: {tuple(p.shape)}, {tuple(g.shape)}, {tuple(mm.shape)}, "
                             f"{tuple(vv.shape)}")


def adamw_step(params: list, grads: list, m: list, v: list, step: torch.Tensor, cfg) -> dict:
    """One clipped AdamW step, in place on ``params``, ``m``, ``v`` and the
    int32 counter ``step``, for flat lists of leaves on one CUDA device;
    returns ``{"lr", "grad_norm"}`` as fp32 device scalars."""
    _check(params, grads, m, v, step)
    lib = load_library("adamw")
    device = step.device
    keys = [(_DTYPES[p.dtype], _DTYPES[g.dtype], _DTYPES[mm.dtype]) for p, g, mm in zip(params, grads, m)]
    launches = plan([p.numel() for p in params], keys)
    tables = [
        np.array([(params[i].data_ptr(), grads[i].data_ptr(), m[i].data_ptr(), v[i].data_ptr(),
                   params[i].numel(), c0) for i, c0 in zip(launch.leaves, launch.chunk0)], np.int64)
        for launch in launches
    ]
    blocks = sum(launch.blocks for launch in launches)
    partials = torch.empty(blocks, dtype=torch.float32, device=device)
    scalars = torch.empty(len(SCALARS), dtype=torch.float32, device=device)
    finish, update = _hyper(cfg)
    dev = device.index or 0
    kw = dict(device=device, launches=LAUNCHES, counter=_COUNTER)
    at = partials.data_ptr()
    for group, table in zip(launches, tables):
        launch(lib, "adamw_sqnorm", group.key[1], dev, table.ctypes.data, len(group.leaves), group.blocks, CHUNK,
               at, **kw)
        at += 4 * group.blocks
    launch(lib, "adamw_finish", dev, partials, blocks, step, scalars, finish.ctypes.data, **kw)
    for group, table in zip(launches, tables):
        launch(lib, "adamw_update", *group.key, dev, table.ctypes.data, len(group.leaves), group.blocks, CHUNK,
               scalars, update.ctypes.data, **kw)
    return {"lr": scalars[SCALARS.index("lr")], "grad_norm": scalars[SCALARS.index("grad_norm")]}
