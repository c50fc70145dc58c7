"""DeepSeek-7B [dense] — llama-arch [arXiv:2401.02954].

30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    vocab_size=102400,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="deepseek7b-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=160,
    dtype="float32",
)
