"""Transformer blocks, the full-sequence forward and the chunked loss.

Counterparts of the same-named functions in the JAX package's
``models/transformer.py``, for every family: the helpers the serving
steps use (embedding, output head, attention projections, the
feed-forward block) and the training path (``attn_block``,
``apply_layer``, ``forward``, ``encode``, ``decoder_forward``,
``encdec_forward``, ``chunked_ce_loss``, ``loss_fn``).

What differs from the JAX forward:

* Attention always goes through ``ops.flash_attention``, the SSD scan
  through ``ssd_scan.ops.ssd_with_state`` and the RG-LRU scan through
  ``rglru_scan.ops.lru``: on the card their CUDA kernels, on the CPU
  their plain versions.  ``cfg.use_pallas`` is not
  read, and ``cfg.attn_block_q/kv`` (TPU tile sizes) are not used: the
  CUDA kernels choose their own tiles.  That includes the decoder's
  cross-attention, which the JAX package computes with the plain
  ``blocked_attention`` whatever ``use_pallas`` says: here it is the
  flash kernel, non-causal, with the decoder's length for Sq and the
  source's for Skv.
* The layer stack is a Python loop over the layer slices of the stacked
  parameters (``lax.scan`` in JAX); a hybrid model loops over its groups
  (``params["groups"]``), then its tail layers.  ``params["layers"]``,
  ``params["groups"]``, ``params["enc_layers"]`` and
  ``params["dec_layers"]`` may also be lists of per-layer (per-group)
  dicts — the train step hands them in so each gradient lands in its
  slice without a copy.
* ``cfg.remat != "none"`` recomputes each layer — for a hybrid model each
  group, as the JAX forward remats ``group_body`` — in the backward pass
  (``torch.utils.checkpoint``, which saves only the input, as JAX's
  ``"full"`` policy does).
* ``head_pad_to`` and the sharding pins ``_shard_padded_heads`` and
  ``_seq_gather`` do nothing without GSPMD and are not ported.
  ``gather_specs`` (``forward``, ``encode``, ``decoder_forward``,
  ``loss_fn``, and the serving steps of ``models/decode.py``) marks the points where the JAX forward constrains each
  layer's leaves (``_wsc_tree``): a leaf given a callable there is
  replaced by its result when its layer runs — the data-parallel train
  step (``launch.steps.make_train_step_smap``) gathers a rank's shards
  of the layer's weights there, inside the recomputed region under
  remat; a leaf given a ``PartitionSpec`` (no mesh) is left as it is.
* An MoE layer's feed-forward is ``moe.moe_apply`` at the configured
  capacity here (the serving steps call it dropless); each layer's
  ``lb_loss`` is summed into the aux that ``forward`` returns.
* ``forward(..., return_states=True)`` (the prefill path) runs the layer
  stack without gradients and without recomputation and returns each
  layer's decode state, stacked as the JAX layer scan stacks it;
  ``decoder_forward(..., return_states=True)`` does the same for the
  decoder, with the cross-attention keys and values.  Both take ``tp``
  there too (the spmd prefill: each state the rank's heads or channels).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.params import hybrid_structure, torch_dtype

LOSS_CHUNK = 1024


def cdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def embed_tokens(params, cfg: ModelConfig, tokens, tp=None):
    """The token embeddings in the compute type.  With ``tp`` the table is
    the rank's part: a tied table's vocabulary slice (rows of other slices
    are zero here, and the ranks' lookups are summed), an untied table's
    slice of D (the ranks' columns are gathered after the lookup)."""
    table = params["embed"]
    if tp is None:
        return table[tokens.long()].to(cdt(cfg))
    if not cfg.tie_embeddings:
        return tp.gather(table[tokens.long()], -1).to(cdt(cfg))
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return tp.reduce(x).to(cdt(cfg))


def head_logits(params, cfg: ModelConfig, x, tp=None):
    """x: (..., D) -> f32 logits (..., V_padded), never rounded to the
    compute type (the JAX einsum's ``preferred_element_type``).  With
    ``tp``: this rank's vocabulary slice of them (``x`` whole, already
    through ``tp.copy``)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = L.matmul_f32(x, w)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    v0 = tp.rank * logits.shape[-1] if tp is not None else 0
    if v0 + logits.shape[-1] > cfg.vocab:   # pad columns: never predicted
        logits[..., max(cfg.vocab - v0, 0):] = -1e30
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


def _cross_proj(x, w):
    """x (B, S, D) @ w (D, H, dh) -> (B, S, H, dh) in x's type, from the
    float32 product (``matmul_f32``; the JAX einsum's
    ``preferred_element_type``) rounded once: the cross-attention
    projections."""
    B, S, D = x.shape
    return L.matmul_f32(x, w.reshape(D, -1)).to(x.dtype) \
        .reshape(B, S, w.shape[1], w.shape[2])


def _attn_out(o, p, dtype):
    B, S, H, dh = o.shape
    wo = p["wo"]
    return (o.to(dtype).reshape(B, S, H * dh)
            @ wo.reshape(H * dh, wo.shape[-1])).to(dtype)


def _ffn(x, lp, cfg: ModelConfig, dropless=False, tp=None):
    """The feed-forward block: (y, aux) — an MoE layer's ``lb_loss`` and
    ``dropped`` (``dropless``: capacity = tokens, the serving steps'), an
    MLP's none.  ``tp``: split over the ranks of the model axis."""
    if "moe" in lp:
        return moe_mod.moe_apply(x, lp["moe"], cfg, dropless=dropless,
                                 tp=tp)
    return L.mlp_apply(x, lp["mlp"], cfg.activation, tp=tp), {}


def rope_for(cfg: ModelConfig, positions, extras=None):
    """RoPE tables for absolute ``positions`` (B, S), or None; M-RoPE
    reads ``extras["position_ids"]`` (3, B, S) instead (a ``KeyError``
    without them, as in the JAX package)."""
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type == "mrope":
        return L.mrope_tables(extras["position_ids"], cfg.head_dim,
                              cfg.rope_theta, cfg.mrope_sections)
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Blocks (full-sequence)
# ---------------------------------------------------------------------------

def attn_block(x, p, cfg: ModelConfig, rope, *, causal=True, window=0,
               kv=None, tp=None):
    """Self-attention over the whole sequence (``kv`` None), or
    cross-attention of x's queries over precomputed ``kv`` = (K, V)
    (B, Skv, Hkv, dh), RoPE on the queries only.  Returns (out (B, S, D),
    (k, v)).

    ``tp``: where the specs cut the heads over the model axis, ``p`` holds
    this rank's ``wq`` / ``wo`` heads, and ``wk`` / ``wv`` its kv heads —
    or, replicated, the whole of them, of which the rank reads the kv
    heads of its query heads (``_rank_kv``); the rank attends with its
    heads and the ranks' ``wo`` products are summed.  Cross-attention's
    ``kv`` are then the rank's kv heads (``_dec_layer``).  Heads the axis
    does not divide are computed whole on every rank."""
    if tp is not None and tp.splits("heads"):
        if kv is None:
            q, k, v = _attn_proj(tp.copy(x), _rank_kv(p, cfg, tp), rope,
                                 cfg=cfg)
        else:
            q = _cross_proj(tp.copy(x), p["wq"])
            k, v = kv
        o = ops.flash_attention(q, k, v, causal, window)
        return tp.reduce(_attn_out(o, p, x.dtype)), (k, v)
    if kv is None:
        q, k, v = _attn_proj(x, p, rope, cfg=cfg)
    else:
        q = _cross_proj(x, p["wq"])
        if rope is not None:
            q = L.apply_rope(q, *rope)
        k, v = kv
    o = ops.flash_attention(q, k, v, causal, window)
    return _attn_out(o, p, x.dtype), (k, v)


def _rank_kv(p, cfg: ModelConfig, tp):
    """``p`` with a replicated ``wk`` / ``wv`` cut to the kv heads of the
    rank's query heads (``tp.kv_heads``); as it is where the specs cut
    the kv heads too."""
    if tp.splits("kv_heads"):
        return p
    return dict(p, **{k: tp.kv_heads(p[k], cfg.n_heads, cfg.n_kv_heads)
                      for k in ("wk", "wv")})


def apply_layer(x, lp, cfg: ModelConfig, layer_type: str, rope, *,
                window=0, causal=True, tp=None):
    """One block over the whole sequence.  Returns (x, state_for_decode,
    aux).  ``tp``: the block split over the model axis where the specs cut
    its axes (``tensor_parallel``): attention heads, ``ff``, the SSD's
    heads, the RG-LRU's channels."""
    if layer_type == "ssd":
        s, state = ssd_mod.ssd_block_apply(
            L.rms_norm(x, lp["ln"], cfg.norm_eps), lp["ssd"], cfg, tp)
        return x + s, state, {}
    if layer_type == "rec":
        r, state = rglru_mod.rglru_block_apply(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["rec"], cfg, tp)
        h = x + r
        f, aux = _ffn(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp, cfg,
                      tp=tp)
        return h + f, state, aux
    if layer_type not in ("attn", "enc"):
        raise ValueError(layer_type)
    a, (k, v) = attn_block(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                           lp["attn"], cfg, rope, causal=causal,
                           window=window, tp=tp)
    h = x + a
    f, aux = _ffn(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp, cfg, tp=tp)
    return h + f, {"k": k, "v": v}, aux


def layer_params(layers, i: int):
    """Layer ``i``'s parameters: the slice of every stacked leaf, or the
    i-th entry of a per-layer list."""
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


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


def _wsc_tree(lp, specs):
    """A layer's parameters with each leaf that ``specs`` gives a callable
    replaced by its result (the gather of a rank's shards); a
    ``PartitionSpec`` leaf, or no ``specs``, leaves the leaf as it is."""
    if specs is None:
        return lp
    if isinstance(lp, dict):
        return {k: _wsc_tree(v, specs[k]) for k, v in lp.items()}
    return specs(lp) if callable(specs) else lp


def _gathered(fn, specs):
    """``fn(x, p)`` on ``p`` after ``_wsc_tree(p, specs)``."""
    if specs is None:
        return fn
    return lambda x, p: fn(x, _wsc_tree(p, specs))


def _run(fn, x, p, cfg: ModelConfig):
    """``fn(x, p)``, recomputed in the backward pass unless remat is off
    or autograd records nothing (``layers.records_grad``)."""
    if cfg.remat == "none" or not L.records_grad(x, p):
        return fn(x, p)
    return checkpoint(lambda x_: fn(x_, p), x, use_reentrant=False)


def _stack_states(states):
    """Per-layer decode states (dicts of tensors) stacked along a new
    leading axis, as the JAX layer scan stacks its outputs."""
    return {k: (_stack_states([s[k] for s in states])
                if isinstance(states[0][k], dict)
                else torch.stack([s[k] for s in states]))
            for k in states[0]}


def _walk(params, cfg: ModelConfig, x, rope, run, keep, gather_specs=None,
          tp=None):
    """Every layer of the stack in the JAX package's order: a hybrid's
    groups (each its pattern's layers), then its tail; otherwise
    ``n_layers`` layers of one type.  ``run(fn, x, p)`` applies a group or
    a uniform stack's layer (``fn(x, p) -> (x, states, lb_loss)``); the
    tail's layers run directly.  ``keep(state, layer_type)`` maps each
    layer's decode state, or is None to drop the states.  Returns (x,
    states, aux): ``layers`` stacked, or a hybrid's ``groups`` stacked and
    ``tail`` by name, None without ``keep``; aux the sum of every layer's
    ``lb_loss`` (float32, 0 without MoE layers).  ``gather_specs``: the
    ``groups`` or ``layers`` subtree is applied to each group's or layer's
    parameters inside ``run`` (``_wsc_tree``).  ``tp`` goes to every
    layer (``apply_layer``)."""
    gs = gather_specs or {}

    def one(x, lp, t):
        x, s, aux = apply_layer(x, lp, cfg, t, rope, window=_window(cfg, t),
                                tp=tp)
        lb = aux.get("lb_loss", torch.zeros((), device=x.device))
        return x, (keep(s, t) if keep else None), lb

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_pattern:
        pattern = [(f"b{i}_{t}", t) for i, t in enumerate(cfg.block_pattern)]

        def group(x, gp):
            st, lbs = {}, 0.0
            for nm, t in pattern:
                x, st[nm], lb = one(x, gp[nm], t)
                lbs = lbs + lb
            return x, st, lbs

        _, n_groups, _ = hybrid_structure(cfg)
        groups, tail = [], {}
        for g in range(n_groups):
            x, st, lb = run(_gathered(group, gs.get("groups")), x,
                            layer_params(params["groups"], g))
            groups.append(st)
            total = total + lb
        for nm, t in tail_layers(params["tail"]):
            x, tail[nm], lb = one(x, params["tail"][nm], t)
            total = total + lb
        if keep is None:
            return x, None, total
        return x, {"groups": _stack_states(groups), "tail": tail}, total
    lt = cfg.layer_types()[0]
    layer = _gathered(lambda x_, lp: one(x_, lp, lt), gs.get("layers"))
    states = []
    for i in range(cfg.n_layers):
        x, s, lb = run(layer, x, layer_params(params["layers"], i))
        states.append(s)
        total = total + lb
    if keep is None:
        return x, None, total
    return x, {"layers": _stack_states(states)}, total


def _positions(x):
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def _merge_vlm(params, cfg: ModelConfig, tokens, extras, tp=None):
    """The VLM's stub frontend: the precomputed patch embeddings (B, Sv,
    D), in the compute type, ahead of the text's token embeddings."""
    ve = extras["vision_embeds"].to(cdt(cfg))
    return torch.cat([ve, embed_tokens(params, cfg, tokens, tp)], dim=1)


def forward(params, cfg: ModelConfig, tokens, extras=None, *,
            return_states=False, state_fn=None, gather_specs=None, tp=None):
    """Full-sequence forward to the final hidden states: (x (B, S, D),
    aux loss: the sum of the MoE layers' ``lb_loss``).  ``extras`` carries
    a VLM's ``vision_embeds`` (B, Sv, D), which go ahead of the text
    tokens (S = Sv + the tokens), and its M-RoPE ``position_ids`` (3, B,
    S); the other families read nothing from it.  An encoder-decoder
    model runs ``encdec_forward``.

    With ``return_states`` (the prefill path) returns (x, states, aux):
    the stack runs without gradients and without recomputation, and
    ``state_fn(state, layer_type)`` transforms each layer's decode state
    before it is stacked — prefill ring-arranges there, so a windowed
    cache never holds the full sequence for every layer at once.

    ``tp``: the rank's part of the tensor-parallel forward
    (``tensor_parallel``; the spmd train step's, or with
    ``return_states`` the spmd prefill's): the embedding and every layer
    split over the model axis where the specs cut its axes
    (``apply_layer``), the hidden states whole on every rank, and each
    layer's decode state the rank's heads or channels, which
    ``state_fn`` sees."""
    extras = extras or {}
    if cfg.family == "encdec":
        raise ValueError("use encdec_forward")
    if cfg.family == "vlm":
        x = _merge_vlm(params, cfg, tokens, extras, tp)
    else:
        x = embed_tokens(params, cfg, tokens, tp)
    rope = rope_for(cfg, _positions(x), extras)
    if return_states:
        with torch.no_grad():
            x, states, aux = _walk(params, cfg, x, rope,
                                   lambda fn, x_, p: fn(x_, p),
                                   state_fn or (lambda s, t: s),
                                   gather_specs, tp)
            x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, states, aux
    x, _, aux = _walk(params, cfg, x, rope, functools.partial(_run, cfg=cfg),
                      None, gather_specs, tp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


# ---------------------------------------------------------------------------
# Encoder-decoder
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frame_embeds, gather_specs=None,
           tp=None):
    """frame_embeds: (B, S_src, D), precomputed by the stub frontend ->
    the encoder's output (B, S_src, D): non-causal self-attention layers,
    then ``enc_norm``.  ``tp``: each layer split over the model axis
    (``apply_layer``)."""
    x = frame_embeds.to(cdt(cfg))
    rope = rope_for(cfg, _positions(x))

    def layer(x, lp):
        return apply_layer(x, lp, cfg, "enc", rope, causal=False, tp=tp)[0]

    layer = _gathered(layer, (gather_specs or {}).get("enc_layers"))
    for i in range(cfg.enc_layers):
        x = _run(layer, x, layer_params(params["enc_layers"], i), cfg)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _splits_heads(tp) -> bool:
    return tp is not None and tp.splits("heads")


def _dec_layer(x, lp, cfg: ModelConfig, rope, enc_out, tp=None):
    """One decoder layer over the whole target sequence: causal
    self-attention, cross-attention over the encoder's output, the MLP.
    Returns (x, {"k", "v": self-attention, "ck", "cv": cross}).  ``tp``:
    the three split over the model axis where the specs cut their axes;
    the cross-attention's keys and values are then the rank's heads,
    projected from ``enc_out`` as ``decoder_forward`` passes it (through
    ``tp.copy``)."""
    a, (k, v) = attn_block(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                           lp["attn"], cfg, rope, causal=True, tp=tp)
    h = x + a
    cp = _rank_kv(lp["cross"], cfg, tp) if _splits_heads(tp) \
        else lp["cross"]
    ck = _cross_proj(enc_out, cp["wk"])
    cv = _cross_proj(enc_out, cp["wv"])
    c, _ = attn_block(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp["cross"],
                      cfg, None, causal=False, kv=(ck, cv), tp=tp)
    h = h + c
    f, _ = _ffn(L.rms_norm(h, lp["ln3"], cfg.norm_eps), lp, cfg, tp=tp)
    return h + f, {"k": k, "v": v, "ck": ck, "cv": cv}


def decoder_forward(params, cfg: ModelConfig, tokens, enc_out, *,
                    return_states=False, state_fn=None, gather_specs=None,
                    tp=None):
    """The decoder over target ``tokens`` (B, S) attending to ``enc_out``
    (B, S_src, D): the final hidden states (B, S, D).  With
    ``return_states`` (the prefill path) returns (x, states), the layers
    run without gradients and without recomputation, and ``states`` holds
    each layer's ``k``, ``v`` (B, S, H, dh) and ``ck``, ``cv`` (B, S_src,
    H, dh), stacked over the layers after ``state_fn`` (if given) maps
    each layer's dict.  ``tp``: the embedding and each layer split over
    the model axis (``_dec_layer``; with ``return_states`` the states are
    the rank's heads); ``enc_out`` goes through ``tp.copy`` once, which
    sums its gradient over the ranks' heads."""
    x = embed_tokens(params, cfg, tokens, tp)
    rope = rope_for(cfg, _positions(x))
    layers = params["dec_layers"]
    specs = (gather_specs or {}).get("dec_layers")
    if return_states:
        states = []
        with torch.no_grad():
            for i in range(cfg.dec_layers):
                x, st = _dec_layer(x, _wsc_tree(layer_params(layers, i),
                                                specs), cfg, rope, enc_out,
                                   tp)
                states.append(state_fn(st) if state_fn else st)
            x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, _stack_states(states)

    if _splits_heads(tp):
        enc_out = tp.copy(enc_out)

    def layer(x, lp):
        return _dec_layer(x, lp, cfg, rope, enc_out, tp)[0]

    layer = _gathered(layer, specs)
    for i in range(cfg.dec_layers):
        x = _run(layer, x, layer_params(layers, i), cfg)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def encdec_forward(params, cfg: ModelConfig, tokens, extras,
                   gather_specs=None, tp=None):
    """``extras["frame_embeds"]`` through the encoder, then the decoder
    over ``tokens``: (x (B, S, D), aux 0).  ``tp``: both split over the
    model axis."""
    enc_out = encode(params, cfg, extras["frame_embeds"], gather_specs, tp)
    x = decoder_forward(params, cfg, tokens, enc_out,
                        gather_specs=gather_specs, tp=tp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy)
# ---------------------------------------------------------------------------

def chunked_ce_loss(params, cfg: ModelConfig, x, targets, mask, tp=None):
    """x: (B, S, D) final hiddens; mean next-token NLL over ``mask``.  The
    logits are made one sequence chunk of ``LOSS_CHUNK`` at a time, never
    as a whole (B, S, V) tensor.

    ``tp``: vocabulary-parallel — each rank makes its vocabulary slice of
    a chunk's logits, and the max, the sum of exponentials
    (``tp.logsumexp``) and the target logit are reduced over the model
    axis; the token count is the global
    batch's (``tp.batch_sum``), so the result is this rank's share of the
    global mean: the ranks' results add up to it."""
    B, S, D = x.shape
    chunk = min(LOSS_CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the loss chunk "
                         f"{chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    if tp is not None:
        x = tp.copy(x)
    for c0 in range(0, S, chunk):
        logits = head_logits(params, cfg, x[:, c0:c0 + chunk], tp)  # f32
        tc = targets[:, c0:c0 + chunk].long()
        if tp is None:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
        else:
            lse = tp.logsumexp(logits)
            n = logits.shape[-1]
            local = tc - tp.rank * n
            mine = (local >= 0) & (local < n)
            tgt = tp.reduce(torch.gather(
                logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
                * mine)
        mc = mask[:, c0:c0 + chunk].float()
        total = total + ((lse - tgt) * mc).sum()
        count = count + mc.sum()
    if tp is not None:
        count = tp.batch_sum(count)
    return total / count.clamp_min(1.0)


def loss_fn(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01,
            gather_specs=None, tp=None):
    """batch: tokens / targets / mask tensors and the family's extras.
    Returns (loss, {"ce", "aux"}).  ``tp``: a rank's part of the
    tensor-parallel step (``tensor_parallel``): ``ce`` is then the rank's
    share of the global batch's, and ``aux`` the global batch's."""
    extras = {k: v for k, v in batch.items()
              if k not in ("tokens", "targets", "mask")}
    if cfg.family == "encdec":
        x, aux = encdec_forward(params, cfg, batch["tokens"], extras,
                                gather_specs, tp)
    else:
        x, aux = forward(params, cfg, batch["tokens"], extras,
                         gather_specs=gather_specs, tp=tp)
    ce = chunked_ce_loss(params, cfg, x, batch["targets"], batch["mask"],
                         tp)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
