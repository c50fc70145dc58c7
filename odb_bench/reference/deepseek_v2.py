"""DeepSeek-V2 (MLA without a query latent, a dense first layer, then MoE
layers of routed and shared experts), float32, one sample at a time, as the
published DeepseekV2ForCausalLM computes it: pre-RMSNorm blocks; MLA in its
direct form (the query from one projection, the kv latent RMS-normed and
expanded to per-head keys and values, the rope key shared by the heads),
the rope dims read as (rope/2, 2) pairs and rotated with YaRN's frequencies
(``DeepseekV2YarnRotaryEmbedding``), the softmax scaled by
(nope + rope)^-1/2 · mscale(factor, mscale_all_dim)², causal within the
sample; a SiLU-gated MLP in the first ``first_k_dense_replace`` layers; in
the others a softmax router over the published experts, greedy top-k, the
weights renormalised only if ``norm_topk_prob`` and times
``routed_scaling_factor``, the routed experts' SiLU-gated MLPs weighted and
summed, and the shared experts (one MLP ``n_shared_experts`` times as wide)
added; a final RMSNorm and the output head.  Weights are the port's tree
layout: every projection stored (d_in, d_out), the expert slabs (E, d_in,
d_out).

Departures, which the configuration states:
  * one chip's share of an expert-parallel layer: the router scores all
    ``deployment.published.n_routed_experts`` experts, but only the
    ``n_routed_experts`` held here (from ``assumed.held_start``) are
    computed, each over every token that chose it (no capacity, no drop),
    and what the others would add is left out;
  * the vocabulary is the chip's slice of ``vocab_size`` rows, the loss
    over the slice;
  * the loss is the token cross-entropy alone: the sequence-wise balance
    term (``seq_aux``) is not added;
  * the head is untied, as published.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from odb_bench.reference.quant import matmul
from odb_bench.reference.qwen3 import HEAD_BLOCK, Q_BLOCK, head_nll, rms


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(cfg: dict, device) -> tuple:
    """(inv_freq (rope/2,), cos/sin scale) of the published YaRN rotary."""
    rs, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], cfg["rope_theta"]
    factor, original = rs["factor"], rs["original_max_position_embeddings"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)

    def correction_dim(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    return inv_freq, yarn_get_mscale(factor, rs["mscale"]) / yarn_get_mscale(factor, rs["mscale_all_dim"])


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope(x, pos, cfg):
    """x (T, H, rope): the published pairing, then halves rotated."""
    inv_freq, mscale = yarn_inv_freq(cfg, x.device)
    ang = pos[:, None].float() * inv_freq
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = (emb.cos() * mscale)[:, None, :], (emb.sin() * mscale)[:, None, :]
    t, h, d = x.shape
    x = x.view(t, h, d // 2, 2).transpose(3, 2).reshape(t, h, d)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def attention(q, k, v, starts, scale):
    """Causal attention of (T, H, Dqk) q over (T, H, Dqk) k and (T, H, Dv)
    v within each sample [s, e), in query blocks."""
    blocks = []
    for s, e in starts:
        ks, vs = k[s:e].transpose(0, 1), v[s:e].transpose(0, 1)
        kj = torch.arange(0, e - s, device=q.device)[None, :]
        for b in range(s, e, Q_BLOCK):
            be = min(b + Q_BLOCK, e)
            scores = (q[b:be].transpose(0, 1) @ ks.transpose(1, 2)) * scale
            qi = torch.arange(b - s, be - s, device=q.device)[:, None]
            scores = scores.masked_fill(kj > qi, float("-inf"))
            blocks.append((torch.softmax(scores, dim=-1) @ vs).transpose(0, 1))
    return torch.cat(blocks)


def mla(m, a, pos, starts, cfg, quant):
    h, nope, rdim, vdim = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = matmul(a, m["w_q"], quant).view(-1, h, nope + rdim)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, cfg)
    kv = matmul(a, m["w_dkv"], quant)
    ckv = rms(kv[:, :r], m["kv_norm"], eps)
    k_pe = rope(kv[:, None, r:], pos, cfg)
    k_nope = matmul(ckv, m["w_uk"], quant).view(-1, h, nope)
    v = matmul(ckv, m["w_uv"], quant).view(-1, h, vdim)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(-1, h, -1)], dim=-1)
    out = attention(query, key, v, starts, softmax_scale(cfg))
    return matmul(out.reshape(-1, h * vdim), m["wo"], quant)


def mlp(f, a, quant):
    return matmul(F.silu(matmul(a, f["w_gate"], quant)) * matmul(a, f["w_in"], quant), f["w_out"], quant)


def experts(w, a, cfg, quant):
    """The routed experts held here over every token that chose them, plus
    the shared experts."""
    probs = torch.softmax(a @ w["router"], dim=-1)  # the router stays fp32, as published
    weights, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        weights = weights / weights.sum(-1, keepdim=True)
    weights = weights * cfg["routed_scaling_factor"]
    out = torch.zeros_like(a)
    start = cfg["assumed"]["held_start"]
    for e in range(cfg["n_routed_experts"]):
        chose = idx == start + e  # (T, k): at most one choice a token
        rows = chose.any(-1).nonzero()[:, 0]
        expert = {name: w[name][e] for name in ("w_in", "w_gate", "w_out")}
        gate = (weights * chose).sum(-1)[rows, None]
        out = out.index_add(0, rows, gate * mlp(expert, a[rows], quant))
    return out + mlp(w["shared"], a, quant)


def layer(w, x, pos, starts, cfg, quant):
    eps = cfg["rms_norm_eps"]
    x = x + mla(w["mixer"], rms(x, w["norm_mixer"]["scale"], eps), pos, starts, cfg, quant)
    a = rms(x, w["norm_ffn"]["scale"], eps)
    return x + (experts(w["moe"], a, cfg, quant) if "moe" in w else mlp(w["mlp"], a, quant))


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
