"""Mixtral 8x22B — MoE 8 experts top-2, GQA, sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    activation="swiglu",
    n_experts=8,
    top_k=2,
    window=4096,              # SWA -> bounded decode state, long_500k runs
    rope_theta=1_000_000.0,
)
