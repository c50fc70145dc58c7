"""Architecture configuration for the assigned model pool (a copy of the JAX
package's ``ArchConfig``, so one config describes both), and
``PortArchConfig`` for the architectures only the port describes."""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encoder", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    vocab_size: int

    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qk_norm: bool = False
    attn_kind: Literal["gqa", "mla", "none"] = "gqa"
    causal: bool = True
    rope_theta: float = 1e6

    # MLA (DeepSeek-V3; DeepSeek-V2-Lite has no query latent: q_lora_rank 0
    # gives one query projection ``w_q``)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # FFN
    d_ff: int = 0
    act: Literal["silu", "gelu"] = "silu"
    gated_mlp: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0  # dsv3: leading dense layers
    moe_every: int = 1  # jamba: MoE on every 2nd layer
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25

    # hybrid / SSM
    attn_period: int = 0  # jamba: one attention layer per `attn_period`
    d_state: int = 0  # SSD state size
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    d_conv: int = 4

    # norm / misc
    norm: Literal["rms", "ln", "ln_nonparam"] = "rms"
    is_encoder: bool = False
    input_embeds: bool = False  # modality frontend stub feeds embeddings
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    logits_fp32: bool = True
    # Training remat: "full" recomputes each layer in the backward
    # (torch.utils.checkpoint around every layer); "dots" keeps the layer's
    # products without a batch dimension and recomputes the rest (JAX's
    # dots_with_no_batch_dims_saveable); "none" keeps every activation.
    remat: str = "full"

    # ---- kernel routing ----
    # Cache-free attention (training, packed prefill): "xla" = the plain
    # blockwise masked attention in models/attention.py (the name is kept
    # from the JAX package); "flash" = the hand-written segment flash kernels
    # (repro_torch.kernels; their plain version on CPU tensors); "auto" =
    # flash when the batch is packed (segments present) and the tensors lie
    # on a CUDA device, xla otherwise.  Decode always takes the plain path.
    attn_impl: Literal["xla", "flash", "auto"] = "auto"
    # Flash kernel variant: "dense" walks every kv block and skips dead ones;
    # "pruned" walks only the live blocks listed by the liveness tables;
    # "auto" = pruned exactly when segments are present on a CUDA device.
    # Without segments there is no liveness table and every variant is dense.
    attn_grid: Literal["dense", "pruned", "auto"] = "auto"
    # Flash kernel block schedule; 0 = the largest divisor of S ≤ 128.
    attn_block_q: int = 0
    attn_block_kv: int = 0
    # Measured per-shape block probe (kernels/autotune.py): the schedule of
    # each shape cell is timed on the device and cached; off = the heuristic.
    attn_autotune: bool = False

    # Training and sharding levers of the JAX package, kept so one config
    # describes both packages; the port does not read them.
    bf16_grad_barrier: bool = False
    sequence_sharding: bool = False
    attn_head_constraint: bool = False

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def experts_held(self) -> int:
        """Experts whose slabs this model holds (the router scores all
        ``n_experts``)."""
        return self.moe_held or self.n_experts

    @property
    def uses_attention(self) -> bool:
        return self.attn_kind != "none"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' | 'ssm' for the mixing sublayer of layer `layer_idx`."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            # Jamba: one attention layer per `attn_period` (offset mid-period).
            return "attn" if layer_idx % self.attn_period == self.attn_period // 2 else "ssm"
        return "attn"

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        if layer_idx < self.first_k_dense:
            return False
        return (layer_idx - self.first_k_dense) % self.moe_every == 0

    def param_count(self) -> int:
        """Total parameters (embeddings + stack), exact for our layout."""
        d = self.d_model
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # unembed
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attn_kind == "mla":
                    q_width = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    q = (d * self.q_lora_rank + self.q_lora_rank * q_width if self.q_lora_rank
                         else d * q_width)
                    kv = d * (self.kv_lora_rank + self.qk_rope_dim)
                    kv += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim
                    )
                    o = self.n_heads * self.v_head_dim * d
                    total += q + kv + o
                else:
                    total += d * self.n_heads * self.d_head  # Q
                    total += 2 * d * self.n_kv_heads * self.d_head  # K,V
                    total += self.n_heads * self.d_head * d  # O
            else:  # ssm
                di = self.d_inner
                in_proj = d * (2 * di + 2 * self.d_state + self.n_ssm_heads)
                total += in_proj + self.d_conv * (di + 2 * self.d_state)
                total += self.n_ssm_heads * 2  # A_log, D
                total += di * d  # out_proj
            # FFN / MoE
            if self.layer_is_moe(i):
                e_ff = self.moe_d_ff or self.d_ff
                per_expert = (3 if self.gated_mlp else 2) * d * e_ff
                total += self.experts_held * per_expert + d * self.n_experts  # router
                total += self.n_shared_experts * per_expert
                if self.dense_residual:
                    total += (3 if self.gated_mlp else 2) * d * self.d_ff
            elif self.d_ff:
                total += (3 if self.gated_mlp else 2) * d * self.d_ff
            # norms
            if self.norm != "ln_nonparam":
                total += 2 * d
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k counting)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        e_ff = self.moe_d_ff or self.d_ff
        per_expert = (3 if self.gated_mlp else 2) * d * e_ff
        moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        # Of the experts held, a token reaches top_k / n_experts on average.
        inactive = moe_layers * per_expert * self.experts_held * (self.n_experts - self.top_k) // self.n_experts
        return total - inactive


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An architecture the JAX package does not describe
    (``configs.PORT_ARCH_IDS``): :class:`ArchConfig` with the port's own
    settings as fields."""

    # MLA's rotary: "halves" rotates the two halves of the rope dims;
    # "pairs" first reads each rope vector as (rope/2, 2) and transposes it,
    # as DeepSeek-V2's published code reads its weights.
    rope_pairing: Literal["halves", "pairs"] = "halves"
    # YaRN on MLA's rope dims (DeepSeek-V2's ``rope_scaling``, with its
    # original context and ramp, ``layers.yarn_frequencies``); factor 0 = off.
    # mscale_all_dim gives the softmax scale's temperature (0 = none).
    yarn_factor: float = 0.0
    yarn_mscale_all_dim: float = 0.0
    # "capacity" drops the pairs past capacity_factor (GShard, the JAX
    # package's); "dropless" computes every pair routed to an expert held
    # here: experts [moe_held_start, moe_held_start + moe_held) of the
    # router's n_experts (moe_held 0 = all of them).
    moe_dispatch: Literal["capacity", "dropless"] = "capacity"
    moe_held: int = 0
    moe_held_start: int = 0
    moe_renormalize: bool = True  # the top-k weights renormalised to sum 1


# ArchConfig carries the port's own settings at their defaults as class
# attributes, not fields, so that it stays the JAX package's field for field.
for _field in dataclasses.fields(PortArchConfig):
    if _field.name not in ArchConfig.__dataclass_fields__:
        setattr(ArchConfig, _field.name, _field.default)
del _field
