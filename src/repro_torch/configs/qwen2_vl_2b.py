"""Qwen2-VL 2B — VLM backbone, M-RoPE, dynamic-resolution frontend STUBBED.

[arXiv:2409.12191; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

Per the assignment the modality frontend is a stub: ``input_specs()`` provides
precomputed patch embeddings occupying ``vision_frac`` of the sequence, plus
(3, B, S) M-RoPE position ids (temporal/height/width components).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,               # 12 % 16 != 0: heads replicated on model axis
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    activation="swiglu",
    rope_type="mrope",
    mrope_sections=(16, 24, 24),   # sums to head_dim // 2 = 64
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    vision_frac=0.25,
)
