"""OLMo-1B [dense] — non-parametric LN [arXiv:2402.00838].

16L d_model=2048 16H (kv=16, MHA) d_ff=8192 vocab=50304.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    vocab_size=50304,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=8192,
    norm="ln_nonparam",
    gated_mlp=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="olmo-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=256,
    dtype="float32",
)
