"""Transformer blocks, the full-sequence forward and the chunked loss.

Counterparts of the same-named functions in the JAX package's
``models/transformer.py``, for the dense decoder, SSM and hybrid
families: the helpers the serving steps use (embedding, output head,
attention projections, the feed-forward block) and the training path
(``attn_block``, ``apply_layer``, ``forward``, ``chunked_ce_loss``,
``loss_fn``).

What differs from the JAX forward:

* Attention always goes through ``ops.flash_attention``, the SSD scan
  through ``ssd_scan.ops.ssd_with_state`` and the RG-LRU scan through
  ``rglru_scan.ops.lru``: on the card their CUDA kernels, on the CPU
  their plain versions.  ``cfg.use_pallas`` is not
  read, and ``cfg.attn_block_q/kv`` (TPU tile sizes) are not used: the
  CUDA kernels choose their own tiles.
* The layer stack is a Python loop over the layer slices of the stacked
  parameters (``lax.scan`` in JAX); a hybrid model loops over its groups
  (``params["groups"]``), then its tail layers.  ``params["layers"]`` and
  ``params["groups"]`` may also be lists of per-layer (per-group) dicts —
  the train step hands them in so each gradient lands in its slice
  without a copy.
* ``cfg.remat != "none"`` recomputes each layer — for a hybrid model each
  group, as the JAX forward remats ``group_body`` — in the backward pass
  (``torch.utils.checkpoint``, which saves only the input, as JAX's
  ``"full"`` policy does).
* ``head_pad_to`` and the sharding pins (``_shard_padded_heads``,
  ``_seq_gather``, ``_wsc_tree``) do nothing on one card and are not
  ported.
* The other families (MoE, encoder-decoder, VLM) raise
  ``NotImplementedError`` (ROADMAP A8).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.params import (PORTED_FAMILIES, hybrid_structure,
                                       torch_dtype)

LOSS_CHUNK = 1024


def cdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(cdt(cfg))


def head_logits(params, cfg: ModelConfig, x):
    """x: (..., D) -> f32 logits (..., V_padded), never rounded to the
    compute type (the JAX einsum's ``preferred_element_type``)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = L.matmul_f32(x, w)
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


# ---------------------------------------------------------------------------
# Blocks (full-sequence)
# ---------------------------------------------------------------------------

def attn_block(x, p, cfg: ModelConfig, rope, *, causal=True, window=0,
               kv=None):
    """Self-attention over the whole sequence.  Returns (out (B, S, D),
    (k, v))."""
    if kv is not None:
        raise NotImplementedError("cross-attention (encoder-decoder) is not "
                                  "ported yet (ROADMAP A8)")
    q, k, v = _attn_proj(x, p, rope, cfg=cfg)
    o = ops.flash_attention(q, k, v, causal, window)
    return _attn_out(o, p, x.dtype), (k, v)


def apply_layer(x, lp, cfg: ModelConfig, layer_type: str, rope, *,
                window=0, causal=True):
    """One block over the whole sequence.  Returns (x, state_for_decode,
    aux)."""
    if layer_type == "ssd":
        s, state = ssd_mod.ssd_block_apply(
            L.rms_norm(x, lp["ln"], cfg.norm_eps), lp["ssd"], cfg)
        return x + s, state, {}
    if layer_type == "rec":
        r, state = rglru_mod.rglru_block_apply(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["rec"], cfg)
        h = x + r
        f = _ffn(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp, cfg)
        return h + f, state, {}
    if layer_type != "attn":
        raise NotImplementedError(f"{layer_type!r} blocks are not ported "
                                  "yet (ROADMAP A8)")
    a, (k, v) = attn_block(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                           lp["attn"], cfg, rope, causal=causal,
                           window=window)
    h = x + a
    f = _ffn(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp, cfg)
    return h + f, {"k": k, "v": v}, {}


def layer_params(layers, i: int):
    """Layer ``i``'s parameters: the slice of every stacked leaf, or the
    i-th entry of a per-layer list."""
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _layer_out(x, lp, cfg, layer_type, rope, window):
    return apply_layer(x, lp, cfg, layer_type, rope, window=window)[0]


def _window(cfg: ModelConfig, layer_type: str) -> int:
    """The attention window of a layer: the hybrid's local attention reads
    ``local_window``, other attention ``window``."""
    if layer_type != "attn":
        return 0
    return cfg.local_window if cfg.block_pattern else cfg.window


def tail_layers(tail):
    """A hybrid model's tail as (name, layer type) in layer order."""
    names = sorted(tail, key=lambda n: int(n[1:].split("_", 1)[0]))
    return [(n, n.split("_", 1)[1]) for n in names]


def _group_out(x, gp, cfg, rope):
    """One group of a hybrid model: its pattern's layers in order."""
    for i, t in enumerate(cfg.block_pattern):
        x = _layer_out(x, gp[f"b{i}_{t}"], cfg, t, rope, _window(cfg, t))
    return x


def _run(fn, x, p, cfg: ModelConfig):
    """``fn(x, p)``, recomputed in the backward pass unless remat is off."""
    if cfg.remat == "none":
        return fn(x, p)
    return checkpoint(lambda x_: fn(x_, p), x, use_reentrant=False)


def forward(params, cfg: ModelConfig, tokens, extras=None):
    """Full-sequence forward to the final hidden states: (x (B, S, D),
    aux loss).  ``extras`` carries nothing for the dense, SSM and hybrid
    families."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family's "
                                  "forward is not ported yet (ROADMAP A8)")
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    rope = rope_for(cfg, positions)
    if cfg.block_pattern:
        _, n_groups, _ = hybrid_structure(cfg)
        group = functools.partial(_group_out, cfg=cfg, rope=rope)
        for g in range(n_groups):
            x = _run(group, x, layer_params(params["groups"], g), cfg)
        for name, t in tail_layers(params["tail"]):
            x = _layer_out(x, params["tail"][name], cfg, t, rope,
                           _window(cfg, t))
    else:
        lt = cfg.layer_types()[0]
        layer = functools.partial(_layer_out, cfg=cfg, layer_type=lt,
                                  rope=rope, window=_window(cfg, lt))
        for i in range(cfg.n_layers):
            x = _run(layer, x, layer_params(params["layers"], i), cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy)
# ---------------------------------------------------------------------------

def chunked_ce_loss(params, cfg: ModelConfig, x, targets, mask):
    """x: (B, S, D) final hiddens; mean next-token NLL over ``mask``.  The
    logits are made one sequence chunk of ``LOSS_CHUNK`` at a time, never
    as a whole (B, S, V) tensor."""
    B, S, D = x.shape
    chunk = min(LOSS_CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the loss chunk "
                         f"{chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        logits = head_logits(params, cfg, x[:, c0:c0 + chunk])  # f32
        lse = torch.logsumexp(logits, dim=-1)
        tc = targets[:, c0:c0 + chunk].long()
        tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
        mc = mask[:, c0:c0 + chunk].float()
        total = total + ((lse - tgt) * mc).sum()
        count = count + mc.sum()
    return total / count.clamp_min(1.0)


def loss_fn(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01):
    """batch: tokens / targets / mask tensors.  Returns (loss, {"ce",
    "aux"})."""
    extras = {k: v for k, v in batch.items()
              if k not in ("tokens", "targets", "mask")}
    x, aux = forward(params, cfg, batch["tokens"], extras)
    ce = chunked_ce_loss(params, cfg, x, batch["targets"], batch["mask"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
