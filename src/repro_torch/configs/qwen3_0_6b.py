"""Qwen3-0.6B [dense] — qk_norm, GQA [hf:Qwen/Qwen3].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128
(Qwen3 decouples head_dim from d_model/n_heads).
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    vocab_size=151936,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    qk_norm=True,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="qwen3-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    dtype="float32",
)
