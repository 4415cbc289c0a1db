"""SeamlessM4T large v2 — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf] 24L d_model=1024 16H (kv=16, MHA) d_ff=8192
vocab=256206.  The speech frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (B, S_src, d_model) for the encoder; the decoder
autoregresses over text tokens with self- + cross-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,              # 24 encoder + 24 decoder (see __post_init__)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,             # not divisible by 16: GSPMD pads vocab shards
    activation="gelu",
    rope_theta=10_000.0,
)
