"""Public flash-attention entry: resolves the block pair and the kernel once.

``grid`` ∈ {dense, pruned, auto} picks between the dense-loop kernels and the
pruned kernels that load only live tiles.  ``auto`` resolves to pruned
exactly when segment ids are present and the tensors lie on a CUDA device;
an explicit ``pruned`` is honored wherever segments exist, and degrades to
dense without them (there is nothing to build liveness from).

:func:`flash_attention` is a ``torch.autograd.Function`` (the counterpart of
the JAX package's ``custom_vjp``): the forward runs K1 or K4 and saves
``(q, k, v, segment_ids, out, lse)`` with the liveness tables; the backward
runs K2+K3 or K5+K6 with the forward's block pair, grid and tables, so the
three passes provably consume one resolution.  Each forward on the pruned
grid builds its tables anew and counts the build in
``kernel_liveness_tables_built_total``.  On CPU tensors both directions take
the plain version.

:func:`ssd_chunked_scan` is the kernel-backed Mamba-2 SSD (K7), through
:class:`_SsdScan`, an autograd Function whose forward is K7 and whose
backward is the gradient of the plain chunked form
(``kernels/ref.ssd_chunked_ref``), recomputed from the saved inputs.  That
is the JAX package's own design: its trainer differentiates the jnp
``ssd_chunked`` (``repro/models/ssm.py``), and the Pallas ``ssd_scan`` has
no backward kernel, so there is no TPU kernel for this backward to port.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.flash_attention import (
    resolve_blocks,
    segment_flash_attention,
    segment_flash_attention_bwd,
    segment_flash_attention_bwd_pruned,
    segment_flash_attention_pruned,
)
from repro_torch.kernels.liveness import LivenessTables, liveness_tables
from repro_torch.kernels.ref import ssd_chunked_ref
from repro_torch.kernels.ssd_scan import ssd_scan

GRID_MODES = ("dense", "pruned", "auto")


def resolve_grid(grid: str | None, segment_ids) -> str:
    """Resolve an ``attn_grid`` request to a concrete kernel variant for one
    call: ``models.attention.resolve_attn_grid``'s rule, read off the
    presence and device of ``segment_ids``."""
    from repro_torch.models.attention import resolve_attn_grid

    if grid is None:
        grid = "auto"
    if grid not in GRID_MODES:
        raise ValueError(f"grid must be one of {GRID_MODES}, got {grid!r}")
    packed = segment_ids is not None
    return resolve_attn_grid(grid, packed=packed, device=segment_ids.device if packed else None)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, block_q, block_kv, grid):
        kw = dict(causal=causal, block_q=block_q, block_kv=block_kv, return_lse=True)
        tables = None  # the CPU path takes the plain version, which needs none
        if grid == "pruned":
            if q.device.type == "cuda":
                tables = liveness_tables(segment_ids, block_q, block_kv, causal)
                obs.counter(
                    "kernel_liveness_tables_built_total",
                    help="liveness tables built for the pruned flash kernels",
                ).inc()
            out, lse = segment_flash_attention_pruned(q, k, v, segment_ids, tables=tables, **kw)
        else:
            out, lse = segment_flash_attention(q, k, v, segment_ids, **kw)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse, *(tables or ()))
        ctx.config = (causal, block_q, block_kv, grid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, out, lse, *tables = ctx.saved_tensors
        causal, block_q, block_kv, grid = ctx.config
        kw = dict(causal=causal, block_q=block_q, block_kv=block_kv)
        do = do.contiguous()
        if grid == "pruned":
            dq, dk, dv = segment_flash_attention_bwd_pruned(
                q, k, v, segment_ids, out, lse, do,
                tables=LivenessTables(*tables) if tables else None, **kw,
            )
        else:
            dq, dk, dv = segment_flash_attention_bwd(q, k, v, segment_ids, out, lse, do, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q, k, v, segment_ids=None, causal=True, block_q=128, block_kv=128,
    grid="auto",
):
    """Segment-masked attention of (B, S, H, D) q over (B, S, KV, D) k/v,
    differentiable in q, k and v."""
    s = q.shape[1]
    block_q, block_kv = resolve_blocks(s, block_q, block_kv)
    mode = resolve_grid(grid, segment_ids)
    return _Flash.apply(q, k, v, segment_ids, causal, block_q, block_kv, mode)


class _SsdScan(torch.autograd.Function):
    """y = SSD(x, adt, dt, B, C) with K7 forward and the plain form's VJP.

    The forward saves the inputs as they come (x, B and C are column views
    of the model's conv output; a copy would cost what the views avoid).
    The backward recomputes ``ssd_chunked_ref`` on detached aliases of them
    under grad and takes ``torch.autograd.grad`` for the inputs that need
    it; each gradient comes back in its input's dtype.  On the bf16 route
    K7's y carries its bf16 roundings (scaled x, the entering state and W as
    two bf16 terms each), while the backward is the exact fp32 gradient of
    the plain form.  The final state is not differentiable: training
    discards it."""

    @staticmethod
    def forward(ctx, x, adt, dt, b_proj, c_proj, initial_state, chunk):
        y, final = ssd_scan(x, adt, dt, b_proj, c_proj, chunk=chunk,
                            initial_state=initial_state, return_final_state=True)
        ctx.save_for_backward(x, adt, dt, b_proj, c_proj, initial_state)
        ctx.chunk = min(chunk, x.shape[1])
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, dy, _dfinal):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad)]
            y, _ = ssd_chunked_ref(*inputs[:5], ctx.chunk, inputs[5])
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs), None)


def ssd_chunked_scan(
    x, dt, a, b_proj, c_proj, *, chunk: int = 256, initial_state=None,
    return_final_state: bool = False,
):
    """Kernel-backed SSD: y = SSD(x, dt, a, B, C) from ``initial_state``
    (zero when None; fp32), with ``adt = a·dt`` formed here in fp32, so the
    gradients of ``a`` and ``dt`` through ``adt`` and ``dt`` join outside
    the kernel.  Differentiable in x, dt, a, B, C and the initial state
    (not through the final state).  Returns ``y``, or ``(y, final_state)``
    with ``return_final_state``."""
    adt = (a[None, None, :] * dt).float()
    y, final = _SsdScan.apply(x, adt, dt.float(), b_proj, c_proj, initial_state, chunk)
    return (y, final) if return_final_state else y
