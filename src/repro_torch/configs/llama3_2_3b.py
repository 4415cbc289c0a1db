"""Llama-3.2 3B — small dense llama3, tied embeddings.

[hf:meta-llama/Llama-3.2-1B family; unverified] 28L d_model=3072 24H
(GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,               # 24 % 16 != 0: heads replicated on model axis
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    activation="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)
