"""Mamba-2 (SSD), float32, one sample at a time, as the published Mamba2
block computes it with one group (ngroups 1): pre-RMSNorm blocks, the
input projections (z, x, B, C, dt), a causal depthwise conv over (x, B,
C) and SiLU, dt = softplus(dt + dt_bias), the SSD recurrence
h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·x_tᵀ, y_t = C_t·h_t + D·x_t evaluated
in chunks (the "minimal SSD" of the Mamba-2 paper, a quadratic form inside
each chunk and the state passed between them, from a zero state at the
sample's start), the gate y·SiLU(z) before the RMSNorm, and the out
projection; a final RMSNorm and the output head over the published
vocabulary.  Departures, the port's, which the configuration states: RMSNorm
eps 1e-6 (mamba_ssm's default is 1e-5), no conv bias, dt clamped to
[1e-4, 10], an untied head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from odb_bench.reference.quant import matmul
from odb_bench.reference.qwen3 import HEAD_BLOCK, head_nll, rms

def segsum(x):
    """(..., T) -> (..., T, T): sum of x[j+1..i] below the diagonal, -inf above."""
    t = x.shape[-1]
    xx = x[..., None].expand(*x.shape, t)
    lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    xx = xx.masked_fill(~lower, 0.0)
    out = torch.cumsum(xx, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, chunk):
    """y (L, H, P) of the SSD from a zero state; L a multiple of ``chunk``."""
    length, h, p = x.shape
    nc = length // chunk
    xd = (x * dt[..., None]).view(nc, chunk, h, p)
    ad = (a[None, :] * dt).view(nc, chunk, h).permute(2, 0, 1)  # (H, c, Q)
    b, c = b.view(nc, chunk, -1), c.view(nc, chunk, -1)
    cum = torch.cumsum(ad, dim=-1)
    y = torch.einsum("cln,csn,hcls,cshp->clhp", c, b, torch.exp(segsum(ad)), xd)
    decay = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("cln,hcl,clhp->chpn", b, decay, xd)
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))  # (H, c+1, c+1)
    states = torch.einsum("hzc,chpn->zhpn", chunk_decay, states)[:-1]
    y = y + torch.einsum("cln,chpn,hcl->clhp", c, states, torch.exp(cum))
    return y.reshape(length, h, p)


def layer(w, x, cfg, quant):
    eps = cfg["norm_epsilon"]
    a_ = cfg["assumed"]
    d = cfg["d_model"]
    di, n, p, k, q = a_["expand"] * d, a_["d_state"], a_["headdim"], a_["d_conv"], a_["chunk_size"]
    h = di // p
    m = w["mixer"]
    u = rms(x, w["norm_mixer"]["scale"], eps)
    z = matmul(u, m["in_z"], quant)
    xbc = torch.cat([matmul(u, m["in_x"], quant), matmul(u, m["in_b"], quant),
                     matmul(u, m["in_c"], quant)], dim=-1)
    length = xbc.shape[0]
    padded = torch.cat([xbc.new_zeros(k - 1, xbc.shape[1]), xbc])
    xbc = F.silu(sum(padded[i:i + length] * m["conv_w"][i] for i in range(k)))
    xs, b, c = xbc[:, :di].reshape(length, h, p), xbc[:, di:di + n], xbc[:, di + n:]
    dt = torch.clamp(F.softplus(matmul(u, m["in_dt"], quant) + m["dt_bias"]), 1e-4, 10.0)
    pad = (-length) % q
    y = ssd(F.pad(xs, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), -torch.exp(m["a_log"]),
            F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad)), q)[:length]
    y = (y + m["d_skip"][None, :, None] * xs).reshape(length, di) * F.silu(z)
    return x + matmul(rms(y, m["out_norm"], eps), m["out_proj"], quant)


def loss_sums(w, samples, cfg, quant=None):
    """(sum of next-token losses, target count) over ``samples``, a list of
    1-D int64 token tensors on one device."""
    total, count = None, 0
    for tokens in samples:
        x = w["embed"][tokens]
        for lw in w["layers"]:
            x = checkpoint(layer, lw, x, cfg, quant, use_reentrant=False)
        valid = torch.ones(len(tokens), device=tokens.device)
        valid[-1] = 0.0
        targets = torch.cat([tokens[1:], tokens[:1]])
        for b in range(0, len(tokens), HEAD_BLOCK):
            sl = slice(b, b + HEAD_BLOCK)
            part = checkpoint(head_nll, x[sl], w["final_norm"]["scale"], w["unembed"], targets[sl],
                              valid[sl], cfg["norm_epsilon"], cfg["vocab_size"], quant, use_reentrant=False)
            total = part if total is None else total + part
        count += len(tokens) - 1
    return total, torch.tensor(float(count), device=total.device)
