"""Jamba-1.5-Large-398B [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576, MoE every 2nd layer.  SSM layers
use the Mamba-2 SSD block for uniformity with mamba2-130m (DESIGN.md §4);
d_state=128.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    vocab_size=65536,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    attn_period=8,
    d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="jamba-smoke",
    n_layers=8,  # one full period: 1 attn + 7 mamba, MoE alternating
    d_model=64,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    d_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    dtype="float32",
)
