"""Model configuration schema shared by all 10 assigned architectures.

A single dataclass covers the whole family spectrum (dense / MoE / hybrid /
SSM / enc-dec / VLM); family-specific fields default to "unused".  Configs
are plain data — no jax imports — so importing a config never touches
device state (required by the dry-run bootstrap ordering).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                        # MLP hidden (per expert for MoE)
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # attention variants
    qk_norm: bool = False            # qwen3, chameleon
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full causal; >0 = SWA width
    global_layers: Sequence[int] = ()  # layer idxs with full attn when SWA
    # MoE
    n_experts: int = 0               # routed experts (0 = dense MLP)
    n_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (hymba) / xLSTM
    ssm_state: int = 0               # mamba state size per channel
    ssm_conv: int = 4                # depthwise conv width
    slstm_every: int = 0             # xlstm: 1 sLSTM per this many blocks
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 0             # precomputed frame count (stub frontend)
    # misc
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    learned_pos: bool = False        # whisper
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # notes carried into DESIGN/EXPERIMENTS tables
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 128 (lane width) so the vocab dim always
        shards over a 16-way model axis; padded logit columns are masked to
        NEG_INF in the unembed (models/layers.py)."""
        return -(-self.vocab // 128) * 128

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode? (DESIGN.md §7)."""
        return self.family in ("ssm",) or (
            self.family == "hybrid" and self.sliding_window > 0
        )

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (small layers/width/vocab)."""
        return dataclasses.replace(self, **overrides)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embeddings included."""
        d, h = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        # attention: q, k, v, o projections
        attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * h
        # mlp
        if self.is_moe:
            per_expert = 3 * d * self.d_ff
            shared = self.n_shared_experts * per_expert
            router = d * self.n_experts
            routed_total = self.n_experts * per_expert
            routed_active = self.moe_top_k * per_expert
            mlp_total = shared + router + routed_total
            mlp_active = shared + router + routed_active
        elif self.d_ff > 0:
            mult = 3 if self.act == "swiglu" else 2
            mlp_total = mlp_active = mult * d * self.d_ff
        else:
            mlp_total = mlp_active = 0
        # mixer extras
        mixer = 0
        if self.family == "hybrid":  # hymba: parallel mamba head
            d_in = nq * h
            mixer = d * 2 * d_in + d_in * self.ssm_conv  # in-proj + conv
            mixer += d_in * self.ssm_state * 2 + d_in    # B, C, dt
            mixer += d_in * d                            # out proj
        if self.family == "ssm":     # xlstm block (mLSTM approximation)
            d_in = d
            mixer = 2 * d * 2 * d_in + 4 * d_in * h * 3 + d_in * d
        norms = 2 * d
        block = attn + mixer + norms + (mlp_total if not active_only
                                        else mlp_active)
        if self.family == "ssm":
            block -= attn  # xlstm has no attention
        total = self.n_layers * block
        total += self.vocab * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab * d                   # unembed
        if self.is_encdec:
            enc_block = attn + (2 if self.act == "gelu" else 3) * d * self.d_ff + 2 * d
            total += self.n_encoder_layers * enc_block
            total += self.n_layers * (attn + d)       # cross-attn + norm
        return int(total)
