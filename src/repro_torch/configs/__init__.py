"""Architecture registry: ``get_config(arch_id)`` and reduced smoke configs."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable
from repro_torch.configs import (
    mixtral_8x22b,
    grok_1_314b,
    llama3_8b,
    llama3_2_3b,
    starcoder2_15b,
    nemotron_4_15b,
    qwen2_vl_2b,
    recurrentgemma_9b,
    mamba2_780m,
    seamless_m4t_large_v2,
)

_MODULES = (
    mixtral_8x22b,
    grok_1_314b,
    llama3_8b,
    llama3_2_3b,
    starcoder2_15b,
    nemotron_4_15b,
    qwen2_vl_2b,
    recurrentgemma_9b,
    mamba2_780m,
    seamless_m4t_large_v2,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def reduced_config(cfg: ModelConfig, *, layers: int = 0) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (shapes + no-NaN only).

    Keeps the family, block pattern, activation, GQA ratio and MoE/SSM
    structure; shrinks widths, depth, vocab and expert count.
    """
    pat = len(cfg.block_pattern) or 1
    n_layers = layers or max(2, pat + (1 if cfg.block_pattern else 0))
    if cfg.block_pattern:
        n_layers = pat + 2  # one full pattern group + a 2-layer tail
    n_heads = 4 if cfg.n_heads else 0
    n_kv = max(1, n_heads // max(1, cfg.q_per_kv)) if cfg.n_heads else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        # dropless capacity (C = block) so decode == forward exactly in tests
        capacity_factor=(min(cfg.n_experts, 4) / max(1, min(cfg.top_k, 2))
                         if cfg.n_experts else cfg.capacity_factor),
        moe_block=64,
        window=min(cfg.window, 64) if cfg.window else 0,
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        lru_width=64 if cfg.lru_width else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssd_chunk=32,
        mrope_sections=(4, 2, 2) if cfg.rope_type == "mrope" else (),
        enc_layers=2 if cfg.family == "encdec" else 0,
        dec_layers=2 if cfg.family == "encdec" else 0,
        attn_block_q=32,
        attn_block_kv=32,
        param_dtype="float32",
        compute_dtype="float32",
    )


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "REGISTRY", "ARCH_IDS", "get_config", "reduced_config",
]
