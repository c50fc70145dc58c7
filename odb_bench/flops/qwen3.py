"""Qwen3 (dense GQA decoder) training FLOPs.

Per real token, 6 FLOPs per weight of every projection (q, k, v, o, the
gated MLP's three and the untied output head over the published
vocabulary); per visible (query, key) pair in each layer, 12·D FLOPs per
query head (QKᵀ and PV, 2·D each forward, twice that backward).  Norms,
rotary, softmax and the loss are left out, as model-FLOP counts do.
"""

from __future__ import annotations


def matmul_params(sizes: dict) -> tuple[int, int]:
    """(weights of the layer stack's projections, weights of the head)."""
    d, h, kv, dh = (sizes["hidden_size"], sizes["num_attention_heads"],
                    sizes["num_key_value_heads"], sizes["head_dim"])
    per_layer = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * sizes["intermediate_size"]
    return sizes["num_hidden_layers"] * per_layer, d * sizes["vocab_size"]


def train_flops(sizes: dict, lengths) -> float:
    stack, head = matmul_params(sizes)
    tokens = sum(lengths)
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    attn = 12.0 * sizes["head_dim"] * sizes["num_attention_heads"] * sizes["num_hidden_layers"]
    return 6.0 * (stack + head) * tokens + attn * pairs
