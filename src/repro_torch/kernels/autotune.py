"""Flash-kernel block schedule.  Only the probe-free default so far: the
measured per-shape probe of the JAX package waits for a later change."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import select_block


def heuristic_blocks(s: int) -> tuple[int, int]:
    """Square blocks at the largest divisor of S that is at most 128."""
    b = select_block(s, 128)
    return b, b
