"""The reference's three training steps and the readings compared.

AdamW as the configuration states it (bf16 weights): clip the gradient to
a global norm, round the clipped gradient to the weights' dtype, update
the fp32 moments, take the bias-corrected step with decoupled weight
decay in fp32 and round the weights back to bf16; learning rate linear
warm-up then cosine.  The hyperparameters come from the harness, which
hands the same ones to the program.

Where the state lives: the fp32 weights, their gradients and the
activations on the device the reference runs on; the start weights and
the fp32 moments on the host, each leaf's moments brought over for its
update and sent back, so that the device holds 8 bytes a weight, not 18.
The device runs the same operations in the same order either way.

Readings, per step and per leaf (leaves in one fixed order):
  * the step's loss (sum of next-token losses over the target count);
  * the norm of the first step's gradient as the optimizer gets it
    (clipped and rounded);
  * the norm of each weight's change over the three steps.
"""

from __future__ import annotations

import math

import torch

from odb_bench.weights import host_like


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


def train_readings(loss_fn, weights: list, steps: list, opt: dict, device, quant=None) -> dict:
    """``weights`` = the start tensors in leaf order, on the host, each in
    the dtype the configuration keeps it in (not modified);
    ``steps`` = one list of samples per step, each a 1-D int64 tensor on
    ``device``; ``loss_fn(tree_of_fp32_leaves, samples, quant)``.
    Returns ``loss`` (per step), ``grad`` and ``change`` (per leaf)."""
    dtypes = [w.dtype for w in weights]
    params = [w.to(device, torch.float32, copy=True).requires_grad_(True) for w in weights]
    pin = torch.device(device).type == "cuda"
    m, v = host_like(params, pin), host_like(params, pin)  # read from the second update on
    b1, b2 = opt["betas"]
    losses, grad1 = [], None
    for k, samples in enumerate(steps):
        loss_sum, count = loss_fn(params, samples, quant)
        loss = loss_sum / torch.clamp(count, min=1.0)
        grads = list(torch.autograd.grad(loss, params))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
            for i, dt in enumerate(dtypes):  # leaf by leaf: one extra gradient at a time
                grads[i] = (grads[i] * scale).to(dt).float()
            if k == 0:
                grad1 = [float(g.norm()) for g in grads]
            step = k + 1
            lr = cosine_lr(step, opt)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for i, (p, g, dt) in enumerate(zip(params, grads, dtypes)):
                mi = torch.zeros_like(p) if k == 0 else m[i].to(device)
                vi = torch.zeros_like(p) if k == 0 else v[i].to(device)
                mi.mul_(b1).add_((1 - b1) * g)
                vi.mul_(b2).add_((1 - b2) * g.square())
                delta = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"]) + opt["weight_decay"] * p
                p.copy_((p - lr * delta).to(dt).float())
                if step < len(steps):  # the last step's moments are not read again
                    m[i].copy_(mi)
                    v[i].copy_(vi)
            del g, mi, vi, delta  # no leaf's update outlives the loop on the device
        del grads
    with torch.no_grad():
        change = [float((p - w.to(device).float()).norm()) for p, w in zip(params, weights)]
    return {"loss": losses, "grad": grad1, "change": change}
