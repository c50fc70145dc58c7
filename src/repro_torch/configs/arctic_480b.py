"""Snowflake Arctic-480B [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (dense residual MLP in parallel
with the MoE branch on every layer), MoE 128e top-2, vocab=32000.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    vocab_size=32000,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="arctic-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=96,
    n_experts=8,
    top_k=2,
    moe_d_ff=96,
    dtype="float32",
)
