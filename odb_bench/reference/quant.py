"""The control's precision: fp8 (e4m3) inputs to every projection.

``fp8`` rounds a tensor to e4m3 with one scale per tensor (its largest
magnitude maps to 448) and passes the gradient straight through, which is
what an fp8 matrix product with a per-tensor scale computes.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def matmul(a: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        return fp8(a) @ fp8(w)
    if quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return a @ w
