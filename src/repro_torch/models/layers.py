"""Primitive layers: norms (RMS, LN), rotary embeddings, MLP, init, the masked loss."""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


def dense_init(generator, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """(d_in, d_out) weights: a standard normal truncated at ±2, scaled by
    1/√d_in, drawn in fp32 from ``generator`` (the JAX package's rule)."""
    x = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x / max(math.sqrt(d_in), 1.0)).to(dtype)


# -- norms ---------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(dt)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Parametric LN, or OLMo's non-parametric LN when weight/bias are None;
    fp32 inside, population variance (``jnp.var``)."""
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def make_norm_params(cfg, dtype, device) -> Params:
    if cfg.norm == "ln_nonparam":
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, params.get("scale"))
    if cfg.norm == "ln":
        return layer_norm(x, params.get("scale"), None)
    return layer_norm(x, None, None)  # non-parametric (OLMo)


# -- rotary --------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta**exponent)  # (d_head/2,)


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention-temperature factor: 0.1·m·ln(s) + 1 (1 for s ≤ 1)."""
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


# DeepSeek-V2's ``rope_scaling``: the context its rotary was trained at, and
# the turns over that context that bound YaRN's ramp.
YARN_ORIGINAL_MAX_POS = 4096
YARN_BETA_FAST = 32.0
YARN_BETA_SLOW = 1.0


def yarn_frequencies(d_head: int, theta: float, factor: float, device=None) -> torch.Tensor:
    """DeepSeek-V2's YaRN inverse frequencies (``DeepseekV2YarnRotaryEmbedding``):
    f_i / factor · (1 − m_i) + f_i · m_i, where m_i falls linearly from 1 to 0
    across the correction range of dims that turn ``YARN_BETA_FAST`` to
    ``YARN_BETA_SLOW`` times over ``YARN_ORIGINAL_MAX_POS`` positions."""
    def dim_of(turns: float) -> float:
        return d_head * math.log(YARN_ORIGINAL_MAX_POS / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_of(YARN_BETA_FAST)), 0)
    high = min(math.ceil(dim_of(YARN_BETA_SLOW)), d_head - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d_head // 2, dtype=torch.float32, device=device) - low) / (high - low)).clamp(0, 1)
    extra = rope_frequencies(d_head, theta, device)
    keep = 1.0 - ramp
    return extra / factor * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, freqs: torch.Tensor | None = None,
               pairs: bool = False) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head); positions: (..., seq).  Rotates the two
    halves of the head dim (not interleaved pairs).  ``freqs`` replaces the
    plain inverse frequencies (YaRN's), and ``pairs`` first reads the head
    dim as (d/2, 2) and transposes it, as DeepSeek-V2 does: the output stays
    in that order, which is the same for queries and keys and so leaves
    their products as published."""
    d_head = x.shape[-1]
    if pairs:
        x = x.unflatten(-1, (d_head // 2, 2)).transpose(-1, -2).flatten(-2)
    if freqs is None:
        freqs = rope_frequencies(d_head, theta, x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP -----------------------------------------------------------------------


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu if name == "silu" else _gelu_tanh


def make_mlp_params(generator, d_model: int, d_ff: int, gated: bool, dtype, device) -> Params:
    p = {
        "w_in": dense_init(generator, d_model, d_ff, dtype, device),
        "w_out": dense_init(generator, d_ff, d_model, dtype, device),
    }
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype, device)
    return p


def apply_mlp(params: Params, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    h = x @ params["w_in"]
    if gated:
        h = act_fn(act)(x @ params["w_gate"]) * h
    else:
        h = act_fn(act)(h)
    return h @ params["w_out"]


# -- losses --------------------------------------------------------------------


def masked_cross_entropy(
    logits: torch.Tensor,  # (..., seq, vocab)
    labels: torch.Tensor,  # (..., seq) int
    mask: torch.Tensor,  # (..., seq) float — 1 on valid targets
    *,
    fp32: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss_sum, token_count) — the Eq. 2 accumulation primitives.

    The *sum*, not the mean, so the trainer can apply sample- or token-level
    scaling per the selected ODB mode.
    """
    if fp32:
        logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - picked) * mask
    return nll.sum(), mask.sum()
