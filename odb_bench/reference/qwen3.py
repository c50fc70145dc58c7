"""Qwen3 (dense decoder with GQA and q/k norms), float32, one sample at a
time, as the published Qwen3ForCausalLM computes it: pre-RMSNorm blocks,
q/k RMS-normed per head before rotary (halves rotated, theta from the
config), causal softmax attention within the sample with key/value heads
shared by groups of query heads, a SiLU-gated MLP, a final RMSNorm and an
output head over the published vocabulary.  Weights are the port's tree
layout: every projection stored (d_in, d_out).  Departures: the head is
untied (the port's); the vocabulary padding columns are cut off.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from odb_bench.reference.quant import matmul

Q_BLOCK = 1024  # queries per attention block: scores never exceed (heads, 1024, L)
HEAD_BLOCK = 4096  # tokens per block of the output head's logits


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, starts):
    """Causal attention of (T, H, D) q over (T, KV, D) k/v within each
    sample [s, e) of ``starts``, in query blocks."""
    h, kv, d = q.shape[1], k.shape[1], q.shape[2]
    blocks = []
    for s, e in starts:
        ks = k[s:e].repeat_interleave(h // kv, dim=1).transpose(0, 1)
        vs = v[s:e].repeat_interleave(h // kv, dim=1).transpose(0, 1)
        kj = torch.arange(0, e - s, device=q.device)[None, :]
        for b in range(s, e, Q_BLOCK):
            be = min(b + Q_BLOCK, e)
            scores = (q[b:be].transpose(0, 1) @ ks.transpose(1, 2)) / d ** 0.5
            qi = torch.arange(b - s, be - s, device=q.device)[:, None]
            scores = scores.masked_fill(kj > qi, float("-inf"))
            blocks.append((torch.softmax(scores, dim=-1) @ vs).transpose(0, 1))
    return torch.cat(blocks)


def layer(w, x, pos, starts, cfg, quant):
    eps, h, kv, d = cfg["rms_norm_eps"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    a = rms(x, w["norm_mixer"]["scale"], eps)
    m = w["mixer"]
    q = matmul(a, m["wq"], quant).view(-1, h, d)
    k = matmul(a, m["wk"], quant).view(-1, kv, d)
    v = matmul(a, m["wv"], quant).view(-1, kv, d)
    q = rope(rms(q, m["q_norm"], eps), pos, cfg["rope_theta"])
    k = rope(rms(k, m["k_norm"], eps), pos, cfg["rope_theta"])
    x = x + matmul(attention(q, k, v, starts).reshape(-1, h * d), m["wo"], quant)
    a = rms(x, w["norm_ffn"]["scale"], eps)
    f = w["mlp"]
    g = torch.nn.functional.silu(matmul(a, f["w_gate"], quant)) * matmul(a, f["w_in"], quant)
    return x + matmul(g, f["w_out"], quant)


def head_nll(x, norm, unembed, targets, valid, eps, vocab, quant):
    logits = matmul(rms(x, norm, eps), unembed[:, :vocab], quant)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, targets[:, None])[:, 0]
    return (nll * valid).sum()


def loss_sums(w, samples, cfg, quant=None):
    """(sum of next-token losses, target count) over ``samples``, a list of
    1-D int64 token tensors on one device."""
    tokens = torch.cat(samples)
    lengths = [len(s) for s in samples]
    ends = torch.tensor(lengths, device=tokens.device).cumsum(0).tolist()
    starts = list(zip([0] + ends[:-1], ends))
    pos = torch.cat([torch.arange(n, device=tokens.device) for n in lengths])
    targets = torch.cat([tokens[1:], tokens[:1]])
    valid = torch.ones(len(tokens), device=tokens.device)
    valid[torch.tensor(ends, device=tokens.device) - 1] = 0.0
    x = w["embed"][tokens]
    for lw in w["layers"]:
        x = checkpoint(layer, lw, x, pos, starts, cfg, quant, use_reentrant=False)
    total = x.new_zeros(())
    for b in range(0, len(tokens), HEAD_BLOCK):
        sl = slice(b, b + HEAD_BLOCK)
        total = total + checkpoint(head_nll, x[sl], w["final_norm"]["scale"], w["unembed"],
                                   targets[sl], valid[sl], cfg["rms_norm_eps"], cfg["vocab_size"],
                                   quant, use_reentrant=False)
    return total, valid.sum()
