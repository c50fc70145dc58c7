"""DeepSeek-V3-671B [moe] — MLA + 1 shared + 256 routed top-8 [arXiv:2412.19437].

61L d_model=7168 128H, MLA (q_lora 1536, kv_lora 512, rope 64, nope 128,
v 128), MoE d_ff=2048, first 3 layers dense (d_ff 18432), vocab=129280.
MTP (multi-token prediction) is out of scope here — noted in DESIGN.md.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    vocab_size=129280,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    d_ff=18432,  # dense layers (first_k_dense)
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    first_k_dense=3,
    norm="rms",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="dsv3-smoke",
    n_layers=3,
    d_model=64,
    vocab_size=512,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_rope_dim=8,
    qk_nope_dim=16,
    v_head_dim=16,
    d_ff=128,
    n_experts=8,
    top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    dtype="float32",
)
