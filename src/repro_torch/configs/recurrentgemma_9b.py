"""RecurrentGemma 9B — Griffin hybrid: RG-LRU recurrence + local attention, 1:2.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000.  Repeating pattern (rec, rec, attn); bounded decode state
(LRU state + 2048-token local window) so long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,             # MQA on the local-attention layers
    d_ff=12288,
    vocab=256000,
    activation="gelu_glu",    # GeGLU, as in the Gemma family
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_window=2048,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
