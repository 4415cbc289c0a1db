"""Model configuration dataclasses.

Every assigned architecture is expressed as a single ``ModelConfig`` covering
dense / MoE / SSM / hybrid / enc-dec LM families.  Configs are frozen and
hashable so they can be closed over by jitted functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- activation / ffn ---
    activation: str = "swiglu"       # swiglu | squared_relu | gelu | relu_glu

    # --- mixture of experts ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_block: int = 2048            # token-block size for dense dispatch

    # --- attention ---
    window: int = 0                  # sliding-window size; 0 = full attention
    rope_theta: float = 10000.0
    rope_type: str = "rope"          # rope | mrope | none
    mrope_sections: Tuple[int, ...] = ()

    # --- hybrid (RG-LRU, RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # repeating pattern, e.g. ("rec","rec","attn")
    lru_width: int = 0
    local_window: int = 0            # window of the hybrid's local-attention layers

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 256

    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- embeddings / misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    vision_frac: float = 0.0         # VLM: fraction of sequence that is patch embeds
    logit_softcap: float = 0.0

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- runtime knobs (not architecture) ---
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    remat: str = "none"              # none | block | full
    seq_shard: bool = False          # shard layer-scan residuals over "model"
                                     # (Megatron-SP style; needs mesh context)
    batch_axes: Tuple[str, ...] = ("data",)   # mesh axes carrying batch
    moe_batched: bool = False        # per-example dispatch (shard_map mode);
                                     # flattened dispatch is GSPMD-friendlier
    head_pad_to: int = 0             # pad Q head-groups so heads shard on the
                                     # model axis (24H/12H vs a 16-wide axis)
    use_pallas: bool = False         # pure-jnp path for dry-run/CPU; Pallas on TPU
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "encdec" and not (self.enc_layers or self.dec_layers):
            object.__setattr__(self, "enc_layers", self.n_layers)
            object.__setattr__(self, "dec_layers", self.n_layers)

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so embed/head shard on any mesh axis."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state is bounded (can serve 500k+ contexts)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True
        # pure sliding-window attention also bounds the KV working set
        return self.window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (enc-dec via its decoder)

    def layer_types(self) -> Tuple[str, ...]:
        """Concrete per-layer block types for hybrid models."""
        if not self.block_pattern:
            if self.family == "ssm":
                return ("ssd",) * self.n_layers
            return ("attn",) * self.n_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        Hq, Hkv, dh = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D  # lm head

        def attn_params():
            return D * Hq * dh + 2 * D * Hkv * dh + Hq * dh * D

        def ffn_params():
            mult = 3 if self.activation in ("swiglu", "relu_glu") else 2
            return mult * D * F

        def moe_ffn_params():
            mult = 3 if self.activation in ("swiglu", "relu_glu") else 2
            return self.n_experts * mult * D * F + D * self.n_experts

        def rglru_params():
            W = self.lru_width or D
            # two in-projections, conv, gates (a/x), lambda, out proj
            return 2 * D * W + self.conv_width * W + 2 * W * W // 1 + W + W * D

        def ssd_params():
            di, ns, ng = self.d_inner, self.ssm_state, self.ssm_groups
            nh = self.ssm_heads
            in_proj = D * (2 * di + 2 * ng * ns + nh)
            conv = self.conv_width * (di + 2 * ng * ns)
            out = di * D
            return in_proj + conv + out + nh + di  # + A, D params + norm

        if self.family == "encdec":
            enc = self.enc_layers * (attn_params() + ffn_params() + 2 * D)
            dec = self.dec_layers * (2 * attn_params() + ffn_params() + 3 * D)
            return total + enc + dec

        per_layer = []
        for lt in self.layer_types():
            if lt == "attn":
                ffn = moe_ffn_params() if self.n_experts else ffn_params()
                per_layer.append(attn_params() + ffn + 2 * D)
            elif lt == "rec":
                ffn = ffn_params()
                per_layer.append(rglru_params() + ffn + 2 * D)
            elif lt == "ssd":
                per_layer.append(ssd_params() + 2 * D)
        return total + sum(per_layer)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        dense_like = dataclasses.replace(self, n_experts=0, top_k=0)
        mult = 3 if self.activation in ("swiglu", "relu_glu") else 2
        expert_per_layer = mult * self.d_model * self.d_ff
        n_attn = sum(1 for t in self.layer_types() if t == "attn")
        return (dense_like.param_count()
                + (self.top_k - 1) * 0  # router negligible
                + n_attn * (self.top_k - 1) * expert_per_layer)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The assigned LM shape set (identical across the 10 archs).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a cell runs, and if not, why (recorded in EXPERIMENTS.md)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full quadratic attention: 500k decode needs sub-quadratic arch"
    return True, ""
