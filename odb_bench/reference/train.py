"""The reference's three training steps and the readings compared.

AdamW as the configuration states it (bf16 weights): clip the gradient to
a global norm, round the clipped gradient to the weights' dtype, update
the fp32 moments, take the bias-corrected step with decoupled weight
decay in fp32 and round the weights back to bf16; learning rate linear
warm-up then cosine.  The hyperparameters come from the harness, which
hands the same ones to the program.

Readings, per step and per leaf (leaves in one fixed order):
  * the step's loss (sum of next-token losses over the target count);
  * the norm of the first step's gradient as the optimizer gets it
    (clipped and rounded);
  * the norm of each weight's change over the three steps.
"""

from __future__ import annotations

import math

import torch


def cosine_lr(step: int, opt: dict) -> float:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    warmup = f32(max(opt["warmup_ratio"] * opt["total_steps"], 1.0))
    s = f32(float(step))
    if s < warmup:
        return float(opt["lr"] * (s / warmup))
    span = torch.clamp(f32(float(opt["total_steps"])) - warmup, min=1.0)
    progress = torch.clamp((s - warmup) / span, 0.0, 1.0)
    cos = opt["min_lr_fraction"] + (1 - opt["min_lr_fraction"]) * 0.5 * (1.0 + torch.cos(math.pi * progress))
    return float(opt["lr"] * cos)


def train_readings(loss_fn, weights: list, steps: list, opt: dict, quant=None) -> dict:
    """``weights`` = the tensors in leaf order, each in the dtype the
    configuration keeps it in (not modified);
    ``steps`` = one list of samples per step, each a 1-D int64 tensor on
    the weights' device; ``loss_fn(tree_of_fp32_leaves, samples, quant)``.
    Returns ``loss`` (per step), ``grad`` and ``change`` (per leaf)."""
    dtypes = [w.dtype for w in weights]
    params = [w.to(torch.float32, copy=True).requires_grad_(True) for w in weights]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = opt["betas"]
    losses, grad1 = [], None
    for k, samples in enumerate(steps):
        loss_sum, count = loss_fn(params, samples, quant)
        loss = loss_sum / torch.clamp(count, min=1.0)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
            grads = [(g * scale).to(dt).float() for g, dt in zip(grads, dtypes)]
            if k == 0:
                grad1 = [float(g.norm()) for g in grads]
            step = k + 1
            lr = cosine_lr(step, opt)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for p, g, mi, vi, dt in zip(params, grads, m, v, dtypes):
                mi.mul_(b1).add_((1 - b1) * g)
                vi.mul_(b2).add_((1 - b2) * g.square())
                delta = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"]) + opt["weight_decay"] * p
                p.copy_((p - lr * delta).to(dt).float())
        del grads
    with torch.no_grad():
        change = [float((p - w.float()).norm()) for p, w in zip(params, weights)]
    return {"loss": losses, "grad": grad1, "change": change}
