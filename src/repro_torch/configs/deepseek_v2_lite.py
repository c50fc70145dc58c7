"""DeepSeek-V2-Lite [moe] — MLA without a query latent, 2 shared + 64 routed
top-6, YaRN [hf:deepseek-ai/DeepSeek-V2-Lite].

27L d_model=2048 16H, MLA (no q latent, kv_lora 512, rope 64, nope 128,
v 128), the first layer dense (d_ff 10944), MoE d_ff=1408 (64 routed
experts, 6 a token, softmax greedy top-k, weights not renormalised,
routed scaling 1), vocab=102400 untied.  Rope theta 10,000 with YaRN
(factor 40 over 4096 positions, beta 32/1, mscale 0.707 on both sides) and
the published pairing of the rope dims.  Dropless dispatch, as the published
training path; ``moe_held`` < 64 gives one chip's share of an expert-parallel
layer.  The sequence-wise balance loss (``seq_aux``) is not part of the loss.
"""

import dataclasses

from repro_torch.models.config import PortArchConfig

CONFIG = PortArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    vocab_size=102400,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    attn_kind="mla",
    rope_theta=10000.0,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    rope_pairing="pairs",
    yarn_factor=40.0,
    yarn_mscale_all_dim=0.707,
    d_ff=10944,  # the dense first layer
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    first_k_dense=1,
    moe_dispatch="dropless",
    moe_renormalize=False,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="dsv2-lite-smoke",
    n_layers=3,
    d_model=64,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    kv_lora_rank=16,
    qk_rope_dim=16,
    qk_nope_dim=16,
    v_head_dim=16,
    d_ff=128,
    n_experts=16,
    top_k=3,
    moe_d_ff=32,
    moe_held=8,
    dtype="float32",
)
