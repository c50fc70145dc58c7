"""Mamba-2 block: the SSD (state-space duality) chunked form (arXiv:2405.21060).

The counterpart of the JAX package's ``repro.models.ssm``.  The SSD of every
forward, training step and prefill goes through
``kernels/ops.ssd_chunked_scan``: the CUDA kernel (K7) on the card, its plain
version on CPU tensors; under grad its autograd Function takes the plain
chunked form's gradient backward.  A one-token step against a cache (decode)
runs the recurrence directly, with no kernel.  As in the JAX package, the
mixer takes no segment ids: on the packed layout the state flows from one
packed sample into the next, and only the shifted labels mask the targets
across them.

Roundings follow the JAX package: the SSD returns y in x's dtype, the skip
term is added in fp32 and the sum cast back to the model dtype, the prefill
cache keeps the final state in the model dtype, and decode reads that state
in fp32 and writes it back in the cache's dtype.  The cache is returned anew
(it is small: (B, H, P, N) and a (B, d_conv - 1, channels) conv tail), as the
JAX package returns it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_chunked_scan
from repro_torch.models.layers import dense_init, rms_norm

Params = dict[str, Any]


class SSMCache(NamedTuple):
    """Per-layer SSM cache; a field that is None reads as zeros (a fresh
    cache), so prefill from a zero state allocates and loads nothing."""

    state: torch.Tensor | None  # (B, H, P, N) inter-chunk / decode SSM state
    conv: torch.Tensor | None  # (B, d_conv - 1, conv_channels) rolling conv window


def make_ssm_params(generator, cfg, dtype, device) -> Params:
    """The JAX package's shapes, dtypes and distributions (``a_log``,
    ``dt_bias`` and ``d_skip`` stay fp32), drawn from ``generator``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    p = {
        "in_z": dense_init(generator, d, di, dtype, device),
        "in_x": dense_init(generator, d, di, dtype, device),
        "in_b": dense_init(generator, d, n, dtype, device),
        "in_c": dense_init(generator, d, n, dtype, device),
        "in_dt": dense_init(generator, d, h, dtype, device),
    }
    conv_w = torch.randn((cfg.d_conv, conv_ch), generator=generator, device=device)
    p["conv_w"] = (conv_w * 0.1).to(dtype)
    p["dt_bias"] = torch.zeros((h,), dtype=torch.float32, device=device)
    p["a_log"] = torch.log(torch.linspace(1.0, 16.0, h, device=device)).float()
    p["d_skip"] = torch.ones((h,), dtype=torch.float32, device=device)
    p["out_norm"] = torch.ones((di,), dtype=dtype, device=device)
    p["out_proj"] = dense_init(generator, di, d, dtype, device)
    return p


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, init: torch.Tensor | None):
    """x: (B, S, C); w: (K, C).  Left-pads with ``init`` (or zeros), so the
    conv is causal; returns the output and the last K - 1 padded inputs."""
    k = w.shape[0]
    if init is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = init.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out, xp[:, -(k - 1) :, :] if k > 1 else pad


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) — positive (post-softplus)
    a: torch.Tensor,  # (H,) negative decay rates
    b_proj: torch.Tensor,  # (B, S, N)
    c_proj: torch.Tensor,  # (B, S, N)
    chunk: int,
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
):
    """Chunked SSD; returns (y (B,S,H,P) in x's dtype, fp32 final state).

    S is zero-padded to a multiple of ``chunk`` (dt = 0 there, so padding
    leaves the state unchanged), as the JAX package does; without padding
    the column views of the caller go to the kernel as they are."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_proj = F.pad(b_proj, (0, 0, 0, pad))
        c_proj = F.pad(c_proj, (0, 0, 0, pad))
    y, final_state = ssd_chunked_scan(
        x, dt, a, b_proj, c_proj, chunk=chunk,
        initial_state=initial_state.float() if initial_state is not None else None,
        return_final_state=True,
    )
    return y[:, :s], final_state


def apply_ssm_block(
    params: Params,
    u: torch.Tensor,  # (B, S, d_model)
    cfg,
    cache: SSMCache | None = None,
) -> tuple[torch.Tensor, SSMCache | None]:
    """Full Mamba-2 mixer: proj → conv → SSD → gate → norm → out."""
    bsz, s, _ = u.shape
    di, n, h, p = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_headdim
    z = u @ params["in_z"]
    xbc = torch.cat([u @ params["in_x"], u @ params["in_b"], u @ params["in_c"]], dim=-1)
    conv_init = cache.conv if cache is not None else None
    xbc, conv_tail = _causal_depthwise_conv(xbc, params["conv_w"], conv_init)
    xbc = F.silu(xbc)
    x_in = xbc[..., :di].reshape(bsz, s, h, p)
    b_proj = xbc[..., di : di + n]
    c_proj = xbc[..., di + n :]
    dt = F.softplus((u @ params["in_dt"]).float() + params["dt_bias"])
    dt = torch.clamp(dt, 1e-4, 10.0)
    a = -torch.exp(params["a_log"])

    if cache is not None and s == 1:
        # Decode: the single-step recurrence (no chunking, no kernel).
        if cache.state is None:
            state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=u.device)
        else:
            state = cache.state.float()  # (B, H, P, N)
        decay = torch.exp(a[None, :] * dt[:, 0, :])  # (B, H)
        upd = torch.einsum("bn,bh,bhp->bhpn", b_proj[:, 0].float(), dt[:, 0], x_in[:, 0].float())
        state = state * decay[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, c_proj[:, 0].float())[:, None]  # (B, 1, H, P)
        state_dtype = cache.state.dtype if cache.state is not None else u.dtype
        new_cache = SSMCache(state=state.to(state_dtype), conv=conv_tail)
    else:
        init_state = cache.state if cache is not None else None
        y, final_state = ssd_chunked(x_in, dt, a, b_proj, c_proj, cfg.ssm_chunk, init_state)
        new_cache = (
            SSMCache(state=final_state.to(u.dtype), conv=conv_tail) if cache is not None else None
        )

    y = y + params["d_skip"][None, None, :, None] * x_in.float()
    y = y.reshape(bsz, s, di).to(u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["out_norm"])
    return y @ params["out_proj"], new_cache


def init_ssm_cache() -> SSMCache:
    """A fresh cache: zero state and conv window, held as None, so the first
    prefill hands the kernel no initial state.  The JAX package allocates
    the zeros; the results are the same."""
    return SSMCache(state=None, conv=None)
