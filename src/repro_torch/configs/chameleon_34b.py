"""Chameleon-34B [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Early fusion means
image content arrives as VQ token ids *inside the text vocabulary* — the VQ
tokenizer is the (stubbed) modality frontend, so the backbone consumes plain
token ids whose realized count is only known post-pipeline (the paper's
visual-token-expansion regime; DESIGN.md §4).
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    vocab_size=65536,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    qk_norm=True,  # chameleon uses qk-norm for stability
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="chameleon-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=160,
    dtype="float32",
)
