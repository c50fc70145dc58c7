"""Yi-34B [dense] — llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000: a GQA group of 7.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    vocab_size=64000,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="yi-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    n_heads=8,  # keeps GQA ratio 56/8 -> 8/2 shape class
    n_kv_heads=2,
    d_head=8,
    d_ff=160,
    dtype="float32",
)
