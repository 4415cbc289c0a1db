"""Transformer helpers the serving steps use: embedding, output head, the
attention projections and the dense feed-forward block.

Counterparts of the same-named functions in the JAX package's
``models/transformer.py``, for the dense decoder family.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import torch_dtype


def cdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(cdt(cfg))


def head_logits(params, cfg: ModelConfig, x):
    """x: (..., D) -> f32 logits (..., V_padded)."""
    if cfg.tie_embeddings:
        logits = (x @ params["embed"].t()).float()
    else:
        logits = (x @ params["head"]).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:   # pad columns are never predicted
        logits[..., cfg.vocab:] = -1e30
    return logits


def _attn_proj(x, p, rope, *, cfg: ModelConfig):
    """x: (B, S, D) -> q (B, S, Hq, dh), k/v (B, S, Hkv, dh), contiguous,
    RoPE applied to q and k."""
    B, S, D = x.shape
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    q = (x @ wq.reshape(D, -1)).reshape(B, S, wq.shape[1], wq.shape[2])
    k = (x @ wk.reshape(D, -1)).reshape(B, S, wk.shape[1], wk.shape[2])
    v = (x @ wv.reshape(D, -1)).reshape(B, S, wv.shape[1], wv.shape[2])
    if rope is not None:
        cos, sin = rope
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _attn_out(o, p, dtype):
    B, S, H, dh = o.shape
    wo = p["wo"]
    return (o.to(dtype).reshape(B, S, H * dh)
            @ wo.reshape(H * dh, wo.shape[-1])).to(dtype)


def _ffn(x, lp, cfg: ModelConfig):
    if "moe" in lp:
        raise NotImplementedError("MoE feed-forward is not ported yet "
                                  "(ROADMAP A8)")
    return L.mlp_apply(x, lp["mlp"], cfg.activation)


def rope_for(cfg: ModelConfig, positions):
    """RoPE tables for absolute ``positions`` (B, S), or None."""
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type != "rope":
        raise NotImplementedError(f"rope_type {cfg.rope_type!r} is not "
                                  "ported yet (ROADMAP A8)")
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
