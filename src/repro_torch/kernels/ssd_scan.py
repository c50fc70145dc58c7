"""Mamba-2 SSD chunk scan: the wrapper over the CUDA kernel K7.

:func:`ssd_scan` replaces the TPU ``repro.kernels.ssd_scan.ssd_scan``: the
SSD of pre-projected inputs, chunk by chunk, with an fp32 ``(P × N)`` state
carried across chunks (``csrc/ssd_scan.cu``).  Beside the TPU kernel's
zero-state output it takes an optional fp32 initial state and returns the
fp32 final state when asked: the two ends of the carried state, which the
model's prefill needs.

Given CUDA tensors it launches the kernel or raises; given CPU tensors it
computes the plain version (``kernels/ref.ssd_chunked_ref``), and so it does
on meta tensors (the dry run's shapes, where nothing runs).  The kernel is
forward only: on a CUDA tensor with grad mode on and an input that requires
grad it raises.  Training differentiates through ``kernels/ops.ssd_chunked_scan``,
whose autograd Function runs this wrapper in its forward (grad mode off)
and the plain chunked form's gradient in its backward.  Each call that launches
adds one to :data:`LAUNCHES`, whatever the number of device launches behind
it (one on the fp32 route, four on the bf16 route).

Two routes, by dtype.  fp32 runs the CUDA-core kernel, one block per
``(b, h)`` walking the chunks in order: the exact rail.  bf16 runs the
chunk-parallel tensor-core passes (scores C·Bᵀ once per chunk, chunk states,
the state passing over chunks, outputs); the wrapper allocates their fp32
scratch (:func:`_scratch_shapes`).

x, B and C may be views with a contiguous last dimension (x also contiguous
over heads) and any batch and row strides: the model passes the column
slices of its conv output as they are, and the kernel reads them in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import launch, load_library

from repro_torch.kernels.ref import ssd_chunked_ref

# Calls that launched K7 since the last reset_launches().
LAUNCHES = {"ssd_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADDIM, MAX_STATE, MAX_CHUNK = 64, 128, 1024  # the kernel's shared-memory tiles

_TILE = 64  # rows of the bf16 route's tiles: the score scratch is padded to it

__all__ = ["LAUNCHES", "reset_launches", "ssd_scan"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_inputs(x, adt, dt, b_p, c_p, chunk, initial_state) -> int:
    """Shapes, dtypes and devices of both paths; returns the resolved chunk."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_p.shape[-1]
    if adt.shape != (bsz, s, h) or dt.shape != (bsz, s, h):
        raise ValueError(f"adt {tuple(adt.shape)} and dt {tuple(dt.shape)} must be {(bsz, s, h)}")
    if b_p.shape != (bsz, s, n) or c_p.shape != (bsz, s, n):
        raise ValueError(f"B {tuple(b_p.shape)} and C {tuple(c_p.shape)} must be (B, S, N) with B, S of x")
    if x.dtype not in _DTYPES or b_p.dtype != x.dtype or c_p.dtype != x.dtype:
        raise TypeError(f"x, B, C must share float32 or bfloat16, got {x.dtype}, {b_p.dtype}, {c_p.dtype}")
    if adt.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"adt and dt must be float32, got {adt.dtype}, {dt.dtype}")
    if initial_state is not None and (
        initial_state.shape != (bsz, h, p, n) or initial_state.dtype != torch.float32
    ):
        raise ValueError(f"initial_state must be (B, H, P, N) = {(bsz, h, p, n)} float32")
    tensors = [x, adt, dt, b_p, c_p] + ([initial_state] if initial_state is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the SSD inputs must lie on one device")
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    return chunk


def _check_cuda(x, adt, dt, b_p, c_p, chunk, initial_state) -> None:
    _, _, h, p = x.shape
    n = b_p.shape[-1]
    if p > MAX_HEADDIM or n > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes P <= {MAX_HEADDIM}, N <= {MAX_STATE}, "
                         f"chunk <= {MAX_CHUNK}; got P={p}, N={n}, chunk={chunk}")
    if x.stride(3) != 1 or x.stride(2) != p:
        raise ValueError("x must be contiguous over (H, P)")
    if b_p.stride(2) != 1 or c_p.stride(2) != 1:
        raise ValueError("B and C must be contiguous over N")
    for name, t in (("adt", adt), ("dt", dt), ("initial_state", initial_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, adt, dt, b_p, c_p, initial_state)
    ):
        raise NotImplementedError(
            "the SSD backward is not ported as a kernel: differentiate through "
            "kernels.ops.ssd_chunked_scan, or call the SSD kernel under torch.no_grad()"
        )


def _scratch_shapes(bsz: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """The fp32 scratch of the bf16 route: the chunk states, written over by
    the state entering each chunk (B, nc, H, P, N); each chunk's decay
    exp(acs_last) (B, nc, H); and the scores C·Bᵀ of each chunk
    (B, nc, Qp, Qp), Qp = chunk rounded up to 64."""
    nc, qp = s // chunk, -(-chunk // _TILE) * _TILE
    return {"states": (bsz, nc, h, p, n), "decay": (bsz, nc, h), "scores": (bsz, nc, qp, qp)}


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    adt: torch.Tensor,  # (B, S, H) fp32: a·dt (negative)
    dt: torch.Tensor,  # (B, S, H) fp32: positive step sizes
    b_p: torch.Tensor,  # (B, S, N)
    c_p: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,  # (B, H, P, N) fp32
    return_final_state: bool = False,
):
    """The SSD of (x, adt, dt, B, C) in chunks of ``min(chunk, S)`` (which
    must divide S).  Returns ``y`` (B, S, H, P) in x's dtype and, with
    ``return_final_state``, the fp32 final state (B, H, P, N)."""
    chunk = _check_inputs(x, adt, dt, b_p, c_p, chunk, initial_state)
    if x.device.type in ("cpu", "meta"):
        y, final = ssd_chunked_ref(x, adt, dt, b_p, c_p, chunk, initial_state)
        return (y, final) if return_final_state else y
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    _check_cuda(x, adt, dt, b_p, c_p, chunk, initial_state)
    bsz, s, h, p = x.shape
    n = b_p.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    final = (
        torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
        if return_final_state else None
    )
    scratch = dict.fromkeys(("states", "decay", "scores"))
    if x.dtype == torch.bfloat16:
        scratch = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
                   for name, shape in _scratch_shapes(bsz, s, h, p, n, chunk).items()}
    launch(
        load_library("ssd_scan"), "ssd_scan_fwd", _DTYPES[x.dtype], x.device.index or 0,
        x, adt, dt, b_p, c_p, initial_state, y, final, scratch["states"], scratch["decay"], scratch["scores"],
        bsz, s, h, p, n, chunk,
        x.stride(0), x.stride(1), b_p.stride(0), b_p.stride(1), c_p.stride(0), c_p.stride(1),
        device=x.device, launches=LAUNCHES, name="ssd_scan",
    )
    return (y, final) if return_final_state else y
