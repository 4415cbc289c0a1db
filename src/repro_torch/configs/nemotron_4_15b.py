"""Nemotron-4 15B — dense, GQA, squared-ReLU MLP, 256k vocab.

[arXiv:2402.16819; unverified] 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    activation="squared_relu",
    rope_theta=10_000.0,
)
