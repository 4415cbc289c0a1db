"""Grok-1 314B — MoE 8 experts top-2, GQA, full attention.

[hf:xai-org/grok-1; unverified] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    activation="gelu",        # grok uses (approx) GeLU expert MLPs
    n_experts=8,
    top_k=2,
    window=0,                 # full attention -> long_500k skipped
    rope_theta=10_000.0,
    logit_softcap=30.0,
)
