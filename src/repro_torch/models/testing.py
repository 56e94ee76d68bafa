"""Reduced-config helpers for smoke tests (same family, tiny dims)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import get_config
from repro_torch.models.config import ModelConfig


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family copy: few layers, narrow width, small vocab/experts.

    Keeps every structural feature of the full config (GQA ratio, qk-norm,
    bias, MoE top-k, SWA/global mix, sLSTM interleave, enc-dec) so the smoke
    test exercises the same code paths the dry-run compiles at full size.
    """
    cfg = get_config(arch_id)
    r: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // cfg.n_heads, 4)),
        d_head=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
    )
    if cfg.is_moe:
        r.update(n_experts=8, n_shared_experts=min(cfg.n_shared_experts, 2),
                 moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.family == "hybrid":
        r.update(ssm_state=8, sliding_window=8, global_layers=(0,))
    if cfg.family == "ssm":
        r.update(slstm_every=2, n_heads=2, n_kv_heads=2, d_head=32)
    if cfg.is_encdec:
        r.update(n_encoder_layers=2, encoder_len=16)
    return dataclasses.replace(cfg, **r)
