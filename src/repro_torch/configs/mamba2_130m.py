"""Mamba2-130M [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768 (attn-free) vocab=50280, ssm_state=128, headdim=64,
expand=2 (d_inner=1536, 24 SSD heads).
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab_size=50280,
    attn_kind="none",
    d_ff=0,  # attn-free, FFN-free: SSD mixer only (per paper architecture)
    gated_mlp=False,
    d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="mamba2-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    d_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    dtype="float32",
)
