"""Mamba2 780M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128.  d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads.
Constant-size decode state: long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    expand=2,
    conv_width=4,
    ssd_chunk=256,
    rope_type="none",
    tie_embeddings=True,
)
