"""Serving path of the dense decoder family: cache layout, the paged block
pool's storage ops, the single-token decode step and the fused multi-token
chunk step.

Caches are ring buffers of width W = min(max_len, window) per layer, kept
as nested dicts of tensors shaped like the JAX package's cache pytrees:
``{"layers": {"k": (L, B, W, Hkv, dh), "v": ...}}``.  The layer stack is a
Python loop over the stacked layer weights.

Where the JAX package updates arrays functionally (``.at[].set``) under
buffer donation, the port writes in place and says so: the pool storage
ops mutate the pool, and both steps update the cache they are given and
return it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (
    _attn_out, _attn_proj, _ffn, cdt, embed_tokens, head_logits, rope_for)


# ---------------------------------------------------------------------------
# Cache layout, declared per family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheLeafSpec:
    batch_axis: int
    token_axis: Optional[int]       # None = per-stream state leaf
    width: int                      # ring width (tokens); 0 for state leaves


@dataclasses.dataclass(frozen=True)
class CacheViewSpec:
    """Per-leaf layout of the serving cache.  ``paths`` name each leaf in
    the cache dict (in the JAX package's leaf order), ``shapes`` give its
    shape for ONE stream (batch axis of size 1)."""
    leaves: Tuple[CacheLeafSpec, ...]
    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtype: torch.dtype
    width: int                      # shared ring width of all token leaves

    @property
    def has_token_leaves(self) -> bool:
        return any(s.token_axis is not None for s in self.leaves)


def _attn_cache_width(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def cache_view_specs(cfg: ModelConfig, max_len: int) -> CacheViewSpec:
    """The dense family's cache: per layer a K and a V ring, stream axis 1,
    token axis 2.  The JAX package finds the same layout by probing
    ``init_cache`` shapes; the port declares it."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} cache "
                                  "layout is not ported yet (ROADMAP A8)")
    W = _attn_cache_width(cfg, max_len)
    leaf = CacheLeafSpec(batch_axis=1, token_axis=2, width=W)
    shape = (cfg.n_layers, 1, W, cfg.n_kv_heads, cfg.head_dim)
    return CacheViewSpec(leaves=(leaf, leaf),
                         paths=(("layers", "k"), ("layers", "v")),
                         shapes=(shape, shape), dtype=cdt(cfg), width=W)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree, spec: CacheViewSpec):
    return [_get(tree, p) for p in spec.paths]


def tree_from_leaves(spec: CacheViewSpec, leaves) -> Dict:
    out: Dict = {}
    for path, leaf in zip(spec.paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict:
    """Zero cache for ``batch`` streams with context capacity ``max_len``."""
    spec = cache_view_specs(cfg, max_len)
    leaves = []
    for s, shape in zip(spec.leaves, spec.shapes):
        shape = list(shape)
        shape[s.batch_axis] = batch
        leaves.append(torch.zeros(shape, dtype=spec.dtype, device=device))
    return tree_from_leaves(spec, leaves)


# ---------------------------------------------------------------------------
# Paged block pool: storage and its gather / scatter / copy ops
# ---------------------------------------------------------------------------
#
# A block pool stores the cache structure with the stream axis replaced by
# a physical-block axis:
#
#   token leaves  (.., B, W, rest)  ->  (.., n_blocks, block_tokens, rest)
#   state leaves  (.., B, rest)     ->  (.., n_states, rest)
#
# A stream is a block table (its W / block_tokens ring pages in ring order)
# plus one state slot; block 0 and state slot 0 are the engine's null
# entries, written but never read.

def _idx(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.long)
    return torch.tensor(list(ids), dtype=torch.long, device=device)


def init_block_pool(cfg: ModelConfig, spec: CacheViewSpec, n_blocks: int,
                    n_states: int, block_tokens: int, device="cuda") -> Dict:
    """Zeroed physical storage for ``n_blocks`` KV pages + ``n_states``
    per-stream state slots (index 0 of each is the engine's null slot)."""
    leaves = []
    for s, shape in zip(spec.leaves, spec.shapes):
        ax = s.batch_axis
        if s.token_axis is not None:
            new = shape[:ax] + (n_blocks, block_tokens) + shape[ax + 2:]
        else:
            new = shape[:ax] + (n_states,) + shape[ax + 1:]
        leaves.append(torch.zeros(new, dtype=spec.dtype, device=device))
    return tree_from_leaves(spec, leaves)


def gather_cache_view(pool, spec: CacheViewSpec, tables, state_slots):
    """Materialise the batched cache for a step.  tables: (B, P) block ids
    (ring order, null-padded); state_slots: (B,).  Returns a cache shaped
    like ``init_cache(cfg, B, max_len)``."""
    B, P = tables.shape
    out = []
    for leaf, s in zip(tree_leaves(pool, spec), spec.leaves):
        ax = s.batch_axis
        if s.token_axis is None:
            out.append(leaf.index_select(ax, _idx(state_slots, leaf.device)))
            continue
        bt = leaf.shape[ax + 1]
        g = leaf.index_select(ax, _idx(tables, leaf.device).reshape(-1))
        out.append(g.reshape(leaf.shape[:ax] + (B, P * bt)
                             + leaf.shape[ax + 2:]))
    return tree_from_leaves(spec, out)


def scatter_cache_view(pool, spec: CacheViewSpec, tables, state_slots, view):
    """Write a batched cache view back into the pool, in place (the JAX
    package returns a new pool under donation).

    Streams may share a real block only under the pool's copy-on-write
    invariant — a shared page is never written by a step, so every copy of
    it carries the same bytes — and null-padded entries all land on the
    null block, whose contents are never read.  So the unspecified order in
    which ``index_copy_`` resolves duplicate indices never matters."""
    B, P = tables.shape
    for leaf, vleaf, s in zip(tree_leaves(pool, spec),
                              tree_leaves(view, spec), spec.leaves):
        ax = s.batch_axis
        if s.token_axis is None:
            leaf.index_copy_(ax, _idx(state_slots, leaf.device), vleaf)
            continue
        bt = leaf.shape[ax + 1]
        vals = vleaf.reshape(vleaf.shape[:ax] + (B * P, bt)
                             + vleaf.shape[ax + 2:])
        leaf.index_copy_(ax, _idx(tables, leaf.device).reshape(-1), vals)
    return pool


def copy_pool_entries(pool, spec: CacheViewSpec, src_blocks, dst_blocks,
                      src_state=None, dst_state=None):
    """Copy physical pages (and optionally a state slot) inside the pool,
    in place — the device half of a cross-domain migration or a CoW fork."""
    for leaf, s in zip(tree_leaves(pool, spec), spec.leaves):
        ax = s.batch_axis
        if s.token_axis is not None:
            if len(src_blocks):
                vals = leaf.index_select(ax, _idx(src_blocks, leaf.device))
                leaf.index_copy_(ax, _idx(dst_blocks, leaf.device), vals)
        elif src_state is not None:
            vals = leaf.index_select(ax, _idx([src_state], leaf.device))
            leaf.index_copy_(ax, _idx([dst_state], leaf.device), vals)
    return pool


def fork_state_slot(pool, spec: CacheViewSpec, src_state, dst_state):
    """Copy one stream's carried-state leaves from ``src_state`` into
    ``dst_state`` (the state half of a prefix-cache hit), in place."""
    return copy_pool_entries(pool, spec, [], [], src_state=src_state,
                             dst_state=dst_state)


def zero_state_slot(pool, spec: CacheViewSpec, state_slot: int):
    """Clear one state slot to the init (zero) state, in place: a recycled
    slot still holds its dead stream's final state."""
    for leaf, s in zip(tree_leaves(pool, spec), spec.leaves):
        if s.token_axis is None:
            leaf.index_fill_(s.batch_axis, _idx([state_slot], leaf.device), 0)
    return pool


def extract_pool_entries(pool, spec: CacheViewSpec, blocks,
                         state_slot: Optional[int] = None):
    """Gather pages (and optionally a state slot) out of the pool: the
    device half of a swap-tier spill.  Returns one tensor per leaf, in
    ``spec`` order, on the pool's device — None where a leaf contributes
    nothing (token leaves for no blocks, state leaves without a slot)."""
    out = []
    for leaf, s in zip(tree_leaves(pool, spec), spec.leaves):
        ax = s.batch_axis
        if s.token_axis is not None:
            out.append(leaf.index_select(ax, _idx(blocks, leaf.device))
                       if len(blocks) else None)
        else:
            out.append(leaf.index_select(ax, _idx([state_slot], leaf.device))
                       if state_slot is not None else None)
    return out


def insert_pool_entries(pool, spec: CacheViewSpec, blocks, host_leaves,
                        state_slot: Optional[int] = None):
    """Scatter ``extract_pool_entries`` leaves back into the pool at
    (freshly reserved) ``blocks`` / ``state_slot``, in place — the
    host-to-device half of a restore.  The page count must match."""
    for leaf, host, s in zip(tree_leaves(pool, spec), host_leaves,
                             spec.leaves):
        ax = s.batch_axis
        if s.token_axis is not None:
            if len(blocks) and host is not None:
                if host.shape[ax] != len(blocks):
                    raise ValueError(f"spill holds {host.shape[ax]} pages, "
                                     f"restoring {len(blocks)}")
                leaf.index_copy_(ax, _idx(blocks, leaf.device),
                                 host.to(leaf.device))
        elif state_slot is not None and host is not None:
            leaf.index_copy_(ax, _idx([state_slot], leaf.device),
                             host.to(leaf.device))
    return pool


def gather_pool_rows(pool, spec: CacheViewSpec, blocks, state_slots=()):
    """One batched gather of many streams' pages + state slots (the
    speculative-decode checkpoint).  Returns device tensors per leaf."""
    out = []
    for leaf, s in zip(tree_leaves(pool, spec), spec.leaves):
        ax = s.batch_axis
        ids = blocks if s.token_axis is not None else state_slots
        out.append(leaf.index_select(ax, _idx(ids, leaf.device))
                   if len(ids) else None)
    return out


def scatter_pool_rows(pool, spec: CacheViewSpec, blocks, leaves,
                      state_slots=()):
    """Inverse of ``gather_pool_rows`` for the rows that roll back, in
    place."""
    for leaf, vals, s in zip(tree_leaves(pool, spec), leaves, spec.leaves):
        ids = blocks if s.token_axis is not None else state_slots
        if len(ids) and vals is not None:
            leaf.index_copy_(s.batch_axis, _idx(ids, leaf.device),
                             vals.to(leaf.device))
    return pool


def next_token_ids(logits, n_tokens):
    """Greedy next token per stream; a stream that consumed no tokens this
    tick (``n_tokens == 0``) yields the -1 sentinel, never a token id."""
    n = torch.as_tensor(n_tokens, device=logits.device)
    return torch.where(n > 0, logits.argmax(dim=-1).to(torch.int32),
                       torch.full_like(n, -1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _layer(params, l: int):
    """Layer ``l``'s weights out of the stacked layer tree (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[l]
    return take(params["layers"])


def _check_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: {cfg.family!r} steps are "
                                  "not ported yet (ROADMAP A8)")


def decode_step(params, cfg: ModelConfig, cache, tokens, pos):
    """One token for every stream.  tokens: (B, 1); pos: (B,) absolute.
    Writes each layer's ring in ``cache`` in place and returns
    (logits (B, V) f32, cache)."""
    _check_dense(cfg)
    x = embed_tokens(params, cfg, tokens)
    rope = rope_for(cfg, pos[:, None])
    kc_all, vc_all = cache["layers"]["k"], cache["layers"]["v"]
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        xin = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(xin, lp["attn"], rope, cfg=cfg)
        kc, vc = L.cache_update(kc_all[l], vc_all[l], k, v, pos)
        kv_pos = L.cache_positions(pos, kc.shape[1])
        o = L.decode_attention(q, kc, vc, kv_pos, pos, window=cfg.window)
        h = x + _attn_out(o, lp["attn"], x.dtype)
        x = h + _ffn(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp, cfg)
        kc_all[l].copy_(kc)
        vc_all[l].copy_(vc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return head_logits(params, cfg, x[:, 0]), cache


def prefill_chunk_step(params, cfg: ModelConfig, spec: CacheViewSpec, cache,
                       tokens, pos, n_tokens, chunk_kernel="dense",
                       all_logits=False):
    """One continuous-batching tick as ONE fused multi-token forward.

    tokens: (B, C); pos: (B,) absolute position of tokens[:, 0]; n_tokens:
    (B,) in [0, C] (0 = idle slot).  Every stream's chunk attends jointly
    over [prior ring, intra-chunk causal] (``layers.chunk_attention``;
    ``chunk_kernel="blocked"`` is the CUDA kernel on the card), then the
    ring write keeps the last W active tokens.  Inactive tokens write no
    ring slot; an idle slot's logits row is NEG_INF.  Writes ``cache`` in
    place and returns (last-active-token logits (B, V), cache) — or, with
    ``all_logits``, the per-position logits (B, C, V) with positions at or
    past ``n_tokens`` set to NEG_INF."""
    _check_dense(cfg)
    B, C = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    q_pos = pos[:, None] + torch.arange(C, device=pos.device)[None, :]
    rope = rope_for(cfg, q_pos)
    kc_all, vc_all = cache["layers"]["k"], cache["layers"]["v"]
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        xin = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _attn_proj(xin, lp["attn"], rope, cfg=cfg)
        o = L.chunk_attention(q, k, v, kc_all[l], vc_all[l], pos, n_tokens,
                              window=cfg.window, kernel=chunk_kernel)
        kc, vc = L.cache_update_chunk(kc_all[l], vc_all[l], k, v, pos,
                                      n_tokens)
        h = x + _attn_out(o, lp["attn"], x.dtype)
        x = h + _ffn(L.rms_norm(h, lp["ln2"], cfg.norm_eps), lp, cfg)
        kc_all[l].copy_(kc)
        vc_all[l].copy_(vc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    n = n_tokens.long()
    if all_logits:
        la = head_logits(params, cfg, x.reshape(B * C, -1)).reshape(B, C, -1)
        active = torch.arange(C, device=x.device)[None, :] < n[:, None]
        return torch.where(active[:, :, None], la, L.NEG_INF), cache
    last = (n - 1).clamp(0, C - 1)
    xl = x[torch.arange(B, device=x.device), last]
    logits = head_logits(params, cfg, xl)
    return torch.where((n > 0)[:, None], logits, L.NEG_INF), cache
