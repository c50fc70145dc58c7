"""AdamW + cosine schedule + global-norm clipping, from scratch.

Matches the paper's training hyperparameters (§3.1): AdamW, cosine decay,
lr 1e-5, warmup_ratio 0.03, grad-clip 4.0, bf16 compute.  Moments may be
stored in bf16 (``moment_dtype``).  The order of operations is the JAX
package's (``repro/train/optimizer.py``): clip against the pre-clip global
norm, round the clipped gradient to the parameter's dtype, then update in
fp32 and round back.

Unlike the JAX package, which returns new arrays, :func:`adamw_update`
updates the parameters and both moments **in place** under
``torch.no_grad()``: a functional update would hold a second copy of the
weights and moments on the card at the step's peak.  The step counter, the
learning rate and the norm stay on the parameters' device, so a step needs
no host sync.

Parameter trees are nested dicts and lists of tensors; their leaves are
visited in one fixed order (dict keys sorted, lists in order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-5
    warmup_ratio: float = 0.03
    total_steps: int = 10_000
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 4.0
    moment_dtype: str = "float32"  # "bfloat16" for the giants
    min_lr_fraction: float = 0.1


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, item) for item in tree]
    return fn(tree)


def cosine_lr(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_fraction·lr``;
    ``step`` is a float32 tensor, and so is the result."""
    f32 = dict(dtype=torch.float32, device=step.device)
    warmup = torch.tensor(max(cfg.warmup_ratio * cfg.total_steps, 1.0), **f32)
    warm = step / warmup
    span = torch.clamp(torch.tensor(float(cfg.total_steps), **f32) - warmup, min=1.0)
    progress = torch.clamp((step - warmup) / span, 0.0, 1.0)
    cos = cfg.min_lr_fraction + (1 - cfg.min_lr_fraction) * 0.5 * (
        1.0 + torch.cos(math.pi * progress)
    )
    return cfg.lr * torch.where(step < warmup, warm, cos)


def init_opt_state(params: Params, cfg: OptimizerConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Clipped gradients (in their own dtypes) and the pre-clip norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params: Params, grads: Params, opt_state: dict, cfg: OptimizerConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``; returns the
    metrics ``{"lr", "grad_norm"}`` (tensors on the parameters' device)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    opt_state["step"] += 1
    step = opt_state["step"].float()
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.betas
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step)
    leaves = zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]),
    )
    for p, g, m, v in leaves:
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return {"lr": lr, "grad_norm": gnorm}
