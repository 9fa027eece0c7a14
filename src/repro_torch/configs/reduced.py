"""Reduced same-family configs for CPU smoke tests.

Same structure (family, GQA ratio shape, MoE/SSM/hybrid features), tiny sizes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-runnable smoke config of the same family."""
    kv_ratio = (cfg.n_heads // cfg.n_kv_heads) if cfg.n_kv_heads else 0
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio) if kv_ratio else 0
    n_layers = max(2, len(cfg.block_pattern)) if cfg.block_pattern else 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads if cfg.n_heads else 0,
        n_kv_heads=n_kv,
        head_dim=16 if cfg.n_heads else None,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        ssm_state=8 if cfg.ssm_state else 0,
        window=8 if cfg.window else 0,
        lru_width=64 if cfg.lru_width else 0,
        n_patches=4 if cfg.n_patches else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_frames=12 if cfg.enc_frames else 0,
        max_decode_ctx=32 if cfg.max_decode_ctx else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        zero1=False,
    )
