"""DeepSeek-V2 (MLA without a query latent, MoE) training FLOPs of one
chip's share.

Per real token, 6 FLOPs per weight of MLA's projections (w_q, w_dkv, w_uk,
w_uv, wo), the dense layers' MLP, each MoE layer's shared experts and fp32
router, and the untied head over the chip's vocabulary slice; the routed
experts at the share a token sends here, k · held / published experts a
layer (6 · 8 / 64 = 0.75 of one expert); per visible (query, key) pair in
each layer, 6·(qk + v) FLOPs per head (QKᵀ over nope + rope dims and PV,
2·D each forward, twice that backward).  Norms, rotary, softmax, routing
and the loss are left out, as model-FLOP counts do.

``expert_work`` is the least work of the held experts' grouped products in
one layer's forward: 2·3·d·ff FLOPs a pair, each pair's row read and its
output written once (bf16) and each held expert's three matrices read once.
"""

from __future__ import annotations


def _expert_weights(sizes: dict) -> int:
    return 3 * sizes["hidden_size"] * sizes["moe_intermediate_size"]


def matmul_params(sizes: dict) -> tuple[float, int]:
    """(weights of the stack's projections that a token runs through, with
    the routed experts at their expected share, weights of the head)."""
    d, h = sizes["hidden_size"], sizes["num_attention_heads"]
    nope, rope, vdim, r = (sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"], sizes["v_head_dim"],
                           sizes["kv_lora_rank"])
    mla = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vdim) + h * vdim * d
    dense = sizes["first_k_dense_replace"]
    moe = sizes["num_hidden_layers"] - dense
    published = sizes["deployment"]["published"]["n_routed_experts"]
    routed = sizes["num_experts_per_tok"] * sizes["n_routed_experts"] / published
    per_moe = (routed + sizes["n_shared_experts"]) * _expert_weights(sizes) + d * published
    stack = sizes["num_hidden_layers"] * mla + dense * 3 * d * sizes["intermediate_size"] + moe * per_moe
    return stack, d * sizes["vocab_size"]


def train_flops(sizes: dict, lengths) -> float:
    stack, head = matmul_params(sizes)
    tokens = sum(lengths)
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    qk = sizes["qk_nope_head_dim"] + sizes["qk_rope_head_dim"]
    attn = 6.0 * (qk + sizes["v_head_dim"]) * sizes["num_attention_heads"] * sizes["num_hidden_layers"]
    return 6.0 * (stack + head) * tokens + attn * pairs


def expert_work(pairs: float, d: int, ff: int, experts: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward of ``experts`` held SiLU-gated experts
    of width ``ff`` over ``pairs`` (token, expert) pairs of width ``d``."""
    flops = 2.0 * 3 * d * ff * pairs
    nbytes = 2.0 * (2 * d * pairs + experts * 3 * d * ff)
    return flops, nbytes
