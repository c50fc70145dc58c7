"""HuBERT-XLarge [audio] — encoder-only [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets).
Encoder-only: bidirectional attention, no decode step (neither the engine
nor ``LM.prefill`` serves it).  The conv feature-extractor frontend is a
stub: a batch carries precomputed frame embeddings ``embeds`` (B, T, d_model).
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    vocab_size=504,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    causal=False,
    is_encoder=True,
    input_embeds=True,
    act="gelu",
    gated_mlp=False,
    norm="ln",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="hubert-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    dtype="float32",
)
