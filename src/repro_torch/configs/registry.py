"""Architecture registry: --arch <id> resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig
from . import (gemma2_27b, gemma3_12b, hubert_xlarge, moonshot_v1_16b_a3b,
               pixtral_12b, qwen2_5_14b, qwen3_moe_30b_a3b, smollm_360m,
               xlstm_350m, zamba2_1_2b)

_MODULES = (qwen2_5_14b, smollm_360m, gemma3_12b, gemma2_27b, xlstm_350m,
            moonshot_v1_16b_a3b, qwen3_moe_30b_a3b, zamba2_1_2b, hubert_xlarge,
            pixtral_12b)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests (few layers, tiny dims)."""
    upd = dict(
        n_layers=max(2, (cfg.attn_every or cfg.slstm_every or cfg.global_every or 2)),
        d_model=64,
        n_heads=max(2, min(4, cfg.n_heads)),
        n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window_size=8 if cfg.window_size else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_expand=cfg.ssm_expand,
    )
    if cfg.is_moe:
        upd.update(n_experts=4, n_active_experts=2, moe_d_ff=32,
                   n_shared_experts=min(1, cfg.n_shared_experts))
    if cfg.attn_every:
        upd.update(attn_every=2, n_layers=4)
    if cfg.slstm_every:
        upd.update(slstm_every=2, n_layers=4)
    if cfg.global_every:
        upd.update(global_every=2, n_layers=4)
    return dataclasses.replace(cfg, **upd)
