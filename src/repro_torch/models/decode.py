"""Serving path of every family: cache layout, the paged block pool's
storage ops, the single-token decode step, the fused multi-token chunk
step, its per-token scan reference (``chunk_decode_step``), whole-prompt
``prefill`` and the encoder-decoder's ``encdec_prefill``.

Caches are nested dicts of tensors shaped like the JAX package's cache
pytrees.  The dense and MoE families keep ring buffers of width W =
min(max_len, window) per layer: ``{"layers": {"k": (L, B, W, Hkv, dh),
"v": ...}}``.
The SSM family keeps per-stream state only: ``{"layers": {"conv_B",
"conv_C", "conv_x": (L, B, K-1, ·) in the compute type, "ssm": (L, B, H,
P, N) float32}}``.  The hybrid family keeps, per group and per tail
layer, the rings of its local-attention layers (width min(max_len,
local_window)) and the RG-LRU state of its recurrent layers (``h``
float32, ``conv`` in the compute type): ``{"groups": {"b0_rec": {"conv":
(G, B, K-1, W), "h": (G, B, W)}, ..., "b2_attn": {"k", "v": (G, B, W,
Hkv, dh)}}, "tail": {"t0_rec": {"conv": (B, K-1, W), "h": (B, W)},
...}}``.  A VLM keeps the dense layout.  The encoder-decoder family keeps
its decoder's self-attention rings (width max_len) and, per stream, the
cross-attention keys and values of its encoded source: ``{"cross_k",
"cross_v": (L_dec, B, S_src, H, dh), "self": {"k", "v": (L_dec, B, W, H,
dh)}}``; the steps read the cross leaves and never write them.  The layer
stack is a Python loop over the stacked layer (or group) weights.  An MoE
layer's experts run dropless in every serving step (capacity = the step's
tokens, as the JAX steps call them); whole-prompt ``prefill`` goes through
``forward`` and so keeps the configured capacity, as in the JAX package.

The single-token step and whole-prompt prefill also run as a rank's part
of the spmd serving steps (``tp``, ``cut``: ``launch.steps``
``make_serve_step_spmd`` / ``make_prefill_spmd``), on the rank's
parameter shards and its shard of the cache.

Where the JAX package updates arrays functionally (``.at[].set``) under
buffer donation, the port writes in place and says so: the pool storage
ops mutate the pool, and the steps update the cache they are given and
return it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.params import hybrid_structure
from repro_torch.models.transformer import (
    _attn_out, _attn_proj, _cross_proj, _ffn, _window, _wsc_tree,
    attn_block, cdt, decoder_forward, embed_tokens, encode, forward,
    head_logits, layer_params, rope_for, tail_layers)


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
    shape for ONE stream (batch axis of size 1), ``dtypes`` its type."""
    leaves: Tuple[CacheLeafSpec, ...]
    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    width: int                      # shared ring width of all token leaves

    @property
    def has_token_leaves(self) -> bool:
        return any(s.token_axis is not None for s in self.leaves)


def _attn_cache_width(cfg: ModelConfig, max_len: int) -> int:
    """Ring width of an attention layer: the hybrid's local attention keeps
    ``local_window`` tokens, other attention ``window`` (0 = all)."""
    w = cfg.local_window if cfg.block_pattern else cfg.window
    return min(max_len, w) if w else max_len


def _hybrid_spec(cfg: ModelConfig, max_len: int) -> CacheViewSpec:
    """The hybrid cache's leaves in the JAX leaf order (sorted keys at
    every level): group leaves carry the group axis first (stream axis 1),
    tail leaves none (stream axis 0)."""
    pattern, n_groups, tail = hybrid_structure(cfg)
    W = _attn_cache_width(cfg, max_len)
    state = rglru_mod.rglru_init_state(cfg, 1, cdt(cfg), device="meta")
    leaves, paths, shapes, dtypes = [], [], [], []
    layers = [("groups", f"b{i}_{t}", t) for i, t in enumerate(pattern)] \
        + [("tail", f"t{i}_{t}", t) for i, t in enumerate(tail)]
    for top, name, t in sorted(layers):
        lead = (n_groups,) if top == "groups" else ()
        ax = len(lead)
        if t == "attn":
            kv = lead + (1, W, cfg.n_kv_heads, cfg.head_dim)
            entries = [("k", CacheLeafSpec(ax, ax + 1, W), kv, cdt(cfg)),
                       ("v", CacheLeafSpec(ax, ax + 1, W), kv, cdt(cfg))]
        elif t == "rec":
            entries = [(k, CacheLeafSpec(ax, None, 0),
                        lead + tuple(state[k].shape), state[k].dtype)
                       for k in sorted(state)]
        else:
            raise ValueError(f"{t!r} layers in a hybrid model: its "
                             "pattern holds attn and rec layers")
        for k, leaf, shape, dtype in entries:
            leaves.append(leaf)
            paths.append((top, name, k))
            shapes.append(shape)
            dtypes.append(dtype)
    has_ring = any(leaf.token_axis is not None for leaf in leaves)
    return CacheViewSpec(leaves=tuple(leaves), paths=tuple(paths),
                         shapes=tuple(shapes), dtypes=tuple(dtypes),
                         width=W if has_ring else 0)


def _encdec_spec(cfg: ModelConfig, max_len: int,
                 src_len: int) -> CacheViewSpec:
    """The encoder-decoder cache's leaves in the JAX leaf order (sorted
    keys): ``cross_k``, ``cross_v`` (state leaves: no token axis), then
    the self-attention rings ``self.k``, ``self.v`` (token axis 2)."""
    L_, H, dh = cfg.dec_layers, cfg.n_kv_heads, cfg.head_dim
    cross = CacheLeafSpec(batch_axis=1, token_axis=None, width=0)
    ring = CacheLeafSpec(batch_axis=1, token_axis=2, width=max_len)
    return CacheViewSpec(
        leaves=(cross, cross, ring, ring),
        paths=(("cross_k",), ("cross_v",), ("self", "k"), ("self", "v")),
        shapes=((L_, 1, src_len, H, dh),) * 2
        + ((L_, 1, max_len, H, dh),) * 2,
        dtypes=(cdt(cfg),) * 4, width=max_len)


def cache_view_specs(cfg: ModelConfig, max_len: int,
                     src_len: int = 0) -> CacheViewSpec:
    """The serving cache's layout, declared per family (the JAX package
    finds the same layout by probing ``init_cache`` shapes).  Dense, MoE
    and VLM: per layer a K and a V ring, stream axis 1, token axis 2.
    SSM: per layer the three conv tails and the SSD state, stream axis 1,
    no token axis (width 0), in the JAX leaf order (sorted keys).  Hybrid:
    see ``_hybrid_spec``; encoder-decoder (``src_len`` source frames):
    ``_encdec_spec``."""
    L_ = cfg.n_layers
    if cfg.family == "encdec":
        return _encdec_spec(cfg, max_len, src_len)
    if cfg.block_pattern:
        return _hybrid_spec(cfg, max_len)
    if cfg.family in ("dense", "moe", "vlm"):
        W = _attn_cache_width(cfg, max_len)
        leaf = CacheLeafSpec(batch_axis=1, token_axis=2, width=W)
        shape = (L_, 1, W, cfg.n_kv_heads, cfg.head_dim)
        return CacheViewSpec(leaves=(leaf, leaf),
                             paths=(("layers", "k"), ("layers", "v")),
                             shapes=(shape, shape),
                             dtypes=(cdt(cfg), cdt(cfg)), width=W)
    if cfg.family == "ssm":
        one = ssd_mod.ssd_init_state(cfg, 1, cdt(cfg), device="meta")
        names = sorted(one)
        return CacheViewSpec(
            leaves=tuple(CacheLeafSpec(batch_axis=1, token_axis=None,
                                       width=0) for _ in names),
            paths=tuple(("layers", k) for k in names),
            shapes=tuple((L_,) + tuple(one[k].shape) for k in names),
            dtypes=tuple(one[k].dtype for k in names), width=0)
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int = 0,
               device="cuda") -> Dict:
    """Zero cache for ``batch`` streams with context capacity ``max_len``
    (and, encoder-decoder, ``src_len`` source frames)."""
    spec = cache_view_specs(cfg, max_len, src_len)
    leaves = []
    for s, shape, dtype in zip(spec.leaves, spec.shapes, spec.dtypes):
        shape = list(shape)
        shape[s.batch_axis] = batch
        leaves.append(torch.zeros(shape, dtype=dtype, device=device))
    return tree_from_leaves(spec, leaves)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   src_len: int = 0) -> Dict:
    """``init_cache``'s tree as ``meta`` tensors: its shapes and types,
    no memory (the JAX package's ``abstract_cache``, ``jax.eval_shape`` of
    ``init_cache``)."""
    return init_cache(cfg, batch, max_len, src_len, device="meta")


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
    for s, shape, dtype in zip(spec.leaves, spec.shapes, spec.dtypes):
        ax = s.batch_axis
        if s.token_axis is not None:
            new = shape[:ax] + (n_blocks, block_tokens) + shape[ax + 2:]
        else:
            new = shape[:ax] + (n_states,) + shape[ax + 1:]
        leaves.append(torch.zeros(new, dtype=dtype, device=device))
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


def extract_pool_entries_async(pool, spec: CacheViewSpec, blocks,
                               state_slot: Optional[int] = None, *, out,
                               stream=None):
    """The issue half of an asynchronous spill: gather the pages (and
    state slot) into fresh device tensors on the current stream — the
    issue-time snapshot, which later in-place writes to the pool cannot
    touch — then copy them into the host tensors ``out`` on the side
    stream ``stream`` without blocking.  ``out`` holds one contiguous
    tensor a leaf with the page (or slot) axis FIRST, None where
    ``extract_pool_entries`` gives None.  Returns the event recorded after
    the copies, or None on the CPU, where the copy is synchronous.  The
    caching allocator is told the snapshot is in use on ``stream``."""
    snap = []
    for leaf, s, dst in zip(tree_leaves(pool, spec), spec.leaves, out):
        ids = blocks if s.token_axis is not None else [state_slot]
        snap.append(None if dst is None else leaf.movedim(
            s.batch_axis, 0).index_select(0, _idx(ids, leaf.device)))
    if stream is None:
        for dst, x in zip(out, snap):
            if x is not None:
                dst.copy_(x)
        return None
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        for dst, x in zip(out, snap):
            if x is not None:
                dst.copy_(x, non_blocking=True)
                x.record_stream(stream)
        event = torch.cuda.Event()
        event.record(stream)
    return event


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

def _layer_stack(params, cfg: ModelConfig, cache, x, step,
                 gather_specs=None):
    """One serving step's layer stack: ``step(x, layer params, layer
    cache, layer type) -> (x, new layer cache)`` per layer in order — the
    layers, a hybrid model's groups then tail, or an encoder-decoder
    model's decoder layers (type ``"dec"``; the layer cache is its ring
    ``k``, ``v`` and its cross ``ck``, ``cv``) — each layer's new cache
    written back into ``cache`` in place.  ``gather_specs``: the
    ``layers``, ``groups`` or ``dec_layers`` subtree is applied to each
    layer's (group's) parameters as it runs (``transformer._wsc_tree``:
    a callable leaf gathers a rank's shards), as the JAX steps constrain
    them.  Counts one walk in ``_layer_stack.walks``."""
    gs = gather_specs or {}

    def run(x, lp, lc, t):
        x, st = step(x, lp, lc, t)
        for k, v in st.items():
            lc[k].copy_(v)
        return x

    _layer_stack.walks += 1

    if cfg.family == "encdec":
        for l in range(cfg.dec_layers):
            lc = {"k": cache["self"]["k"][l], "v": cache["self"]["v"][l],
                  "ck": cache["cross_k"][l], "cv": cache["cross_v"][l]}
            x = run(x, _wsc_tree(layer_params(params["dec_layers"], l),
                                 gs.get("dec_layers")), lc, "dec")
        return x
    if cfg.block_pattern:
        pattern, n_groups, _ = hybrid_structure(cfg)
        for g in range(n_groups):
            gp = _wsc_tree(layer_params(params["groups"], g),
                           gs.get("groups"))
            for i, t in enumerate(pattern):
                nm = f"b{i}_{t}"
                lc = {k: v[g] for k, v in cache["groups"][nm].items()}
                x = run(x, gp[nm], lc, t)
        for nm, t in tail_layers(params["tail"]):
            x = run(x, params["tail"][nm], cache["tail"][nm], t)
        return x
    lt = cfg.layer_types()[0]
    states = cache["layers"]
    for l in range(cfg.n_layers):
        x = run(x, _wsc_tree(layer_params(params["layers"], l),
                             gs.get("layers")),
                {k: v[l] for k, v in states.items()}, lt)
    return x


_layer_stack.walks = 0


def layer_walks() -> int:
    """Walks through the layer stack so far: one a sequential model step
    (the engine's ``measured_model_steps`` reads it)."""
    return _layer_stack.walks


def _row_shape(leaf, s: CacheLeafSpec):
    """Shape that broadcasts a (B,) per-stream mask along ``leaf``'s
    stream axis."""
    shape = [1] * leaf.dim()
    shape[s.batch_axis] = leaf.shape[s.batch_axis]
    return shape


def _slot_index(leaf, s: CacheLeafSpec, pos):
    """Index for ``gather`` / ``scatter_`` on ``leaf``'s token axis: each
    stream's ring slot ``pos % W``, broadcast over the leaf's other axes
    (the token axis of size 1)."""
    shape = list(leaf.shape)
    shape[s.token_axis] = 1
    slot = (pos.long() % leaf.shape[s.token_axis]).reshape(
        _row_shape(leaf, s))
    return slot.expand(shape)


def _step_leaves(cache, spec: CacheViewSpec):
    """The cache leaves a serving step writes, with their specs: all but
    an encoder-decoder model's cross-attention keys and values."""
    pairs = [(leaf, s) for leaf, s, p in zip(tree_leaves(cache, spec),
                                             spec.leaves, spec.paths)
             if p[0] not in ("cross_k", "cross_v")]
    return [leaf for leaf, _ in pairs], [s for _, s in pairs]


def _save_rows(leaves, specs, pos):
    """What one single-token step can write for each stream: the ring
    slot at ``pos % W`` of every token leaf, the whole of every state
    leaf."""
    out = []
    for leaf, s in zip(leaves, specs):
        if s.token_axis is None:
            out.append(leaf.clone())
        else:
            out.append(torch.gather(leaf, s.token_axis,
                                    _slot_index(leaf, s, pos)))
    return out


def _restore_rows(leaves, specs, saved, pos, active):
    """Put back ``saved`` (``_save_rows`` at the same ``pos``) for the
    streams where ``active`` (B,) is False, in place — the port's
    counterpart of the JAX package's ``select_streams``, touching only
    what the step wrote.  No boolean indexing and no host sync, so a CUDA
    graph can hold it."""
    for leaf, s, old in zip(leaves, specs, saved):
        keep = active.reshape(_row_shape(leaf, s))
        if s.token_axis is None:
            leaf.copy_(torch.where(keep, leaf, old))
            continue
        idx = _slot_index(leaf, s, pos)
        new = torch.gather(leaf, s.token_axis, idx)
        leaf.scatter_(s.token_axis, idx, torch.where(keep, new, old))


def chunk_decode_step(params, cfg: ModelConfig, spec: CacheViewSpec, cache,
                      tokens, pos, n_tokens, extras=None, all_logits=False):
    """One continuous-batching tick as C single-token steps: the
    per-token reference of ``prefill_chunk_step`` (``prefill_mode=
    "scan"``), bit-identical to feeding each stream its tokens one a tick.

    tokens: (B, C); pos: (B,) absolute position of tokens[:, 0]; n_tokens:
    (B,) in [0, C] (0 = idle slot).  Step t runs ``decode_step`` over every
    stream at its cursor; a stream with ``n_tokens <= t`` comes out of it
    unchanged — its ring slot at ``pos % W`` and its state rows are saved
    before the step and put back after it — and its cursor stays.  Writes
    ``cache`` in place; returns (logits (B, V) after each stream's last
    active token, NEG_INF for idle streams, cache), or with ``all_logits``
    the logits after every fed token (B, C, V), NEG_INF at and past
    ``n_tokens``.  ``extras`` goes to every ``decode_step``, as in the
    JAX package.  Counts C layer-stack walks."""
    B, C = tokens.shape
    leaves, specs = _step_leaves(cache, spec)
    n = n_tokens.long()
    pos_c = pos
    logits, per = None, []
    for t in range(C):
        active = t < n
        saved = _save_rows(leaves, specs, pos_c)
        lg, _ = decode_step(params, cfg, cache, tokens[:, t:t + 1], pos_c,
                            extras)
        _restore_rows(leaves, specs, saved, pos_c, active)
        if logits is None:
            logits = torch.full_like(lg, L.NEG_INF)
        logits = torch.where(active[:, None], lg, logits)
        if all_logits:
            per.append(lg)
        pos_c = pos_c + active.to(pos_c.dtype)
    if all_logits:
        la = torch.stack(per, dim=1)                          # (B, C, V)
        live = torch.arange(C, device=la.device)[None, :] < n[:, None]
        return torch.where(live[:, :, None], la, L.NEG_INF), cache
    return logits, cache


def _ffn_out(h, lp, cfg: ModelConfig, ln="ln2", tp=None):
    """The residual feed-forward of a serving step: MoE layers dropless.
    ``tp``: split over the model axis where the specs cut ``ff``."""
    f, _ = _ffn(L.rms_norm(h, lp[ln], cfg.norm_eps), lp, cfg,
                dropless=True, tp=tp)
    return h + f


def _step_rope(cfg: ModelConfig, q_pos, extras):
    """RoPE tables of a serving step's queries at positions ``q_pos`` (B,
    C): M-RoPE reads ``extras["position_ids"]`` (3, B, C) when given and
    otherwise broadcasts ``q_pos`` to all three components (where M-RoPE
    is RoPE), as the JAX steps do."""
    if cfg.rope_type == "mrope":
        pid = (extras or {}).get("position_ids")
        if pid is None:
            pid = q_pos[None].expand(3, *q_pos.shape)
        return rope_for(cfg, q_pos, {"position_ids": pid})
    return rope_for(cfg, q_pos)


def _cross_attention(h, lp, lc, cfg: ModelConfig, decode: bool, tp=None,
                     cut=None):
    """A decoder layer's residual cross-attention over its static encoder
    keys and values ``lc["ck"]``, ``lc["cv"]`` (B, S_src, H, dh): a
    single-token step's by ``decode_attention`` with every source frame
    visible (``q_pos`` 2**30), as in the JAX package; a chunk's by the
    flash kernel, non-causal, Sq = C.  ``tp``, ``cut``: the spmd token
    step's (``_attend``), the source frames in place of the ring."""
    xin = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if not decode:
        c, _ = attn_block(xin, lp["cross"], cfg, None, causal=False,
                          kv=(lc["ck"], lc["cv"]))
        return h + c
    B, S_src = h.shape[0], lc["ck"].shape[1]
    src_pos = torch.arange(S_src, device=h.device)[None].expand(B, S_src)
    q_pos = torch.full((B,), 2 ** 30, device=h.device)
    if tp is None:
        cq = _cross_proj(xin, lp["cross"]["wq"])
        co = L.decode_attention(cq, lc["ck"], lc["cv"], src_pos, q_pos)
        return h + _attn_out(co, lp["cross"], h.dtype)
    heads = tp.splits("heads")
    cq = _cross_proj(tp.copy(xin) if heads else xin, lp["cross"]["wq"])
    return h + _attend(cq, lc["ck"], lc["cv"], src_pos, q_pos, lp["cross"],
                       cfg, tp, "ck" in cut, h.dtype)


def _attend(q, kc, vc, kv_pos, q_pos, p, cfg: ModelConfig, tp, split: bool,
            dtype, window=0):
    """The spmd token step's attention output: ``q`` the rank's heads
    (gathered here) or every head, over the rank's slots of a ring cut
    over the model axis (``split``: ``layers.split_decode_attention``)
    or over the whole ring; then the rank's heads into the row-parallel
    ``wo``, summed over the axis."""
    heads = tp.splits("heads")
    if heads:
        q = tp.gather(q, 2)
    if split:
        o = L.split_decode_attention(q, kc, vc, kv_pos, q_pos, tp,
                                     window=window)
    else:
        o = L.decode_attention(q, kc, vc, kv_pos, q_pos, window=window)
    if not heads:
        return _attn_out(o, p, dtype)
    return tp.reduce(_attn_out(o[:, :, tp.heads(cfg.n_heads)], p, dtype))


def _decode_attn_tp(x, lp, lc, cfg: ModelConfig, t: str, rope, pos, tp,
                    cut):
    """The spmd token step's self-attention (residual added) and its new
    ring: the token's q for the rank's heads, its k and v for every kv
    head — gathered where the specs cut ``wk`` / ``wv``, computed whole
    where they are replicated — written by the rank that holds slot
    ``pos % W`` (``cut["k"]``: the ring's window cut over the axis; else
    every rank holds the whole ring)."""
    xin = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    p = lp["attn"]
    heads = tp.splits("heads")
    q, k, v = _attn_proj(tp.copy(xin) if heads else xin, p, rope, cfg=cfg)
    if heads and tp.splits("kv_heads"):
        k, v = tp.gather(k, 2), tp.gather(v, 2)
    split = "k" in cut
    Wl = lc["k"].shape[1]
    W, first = (Wl * tp.size, tp.rank * Wl) if split else (Wl, 0)
    kc, vc = L.cache_update(lc["k"], lc["v"], k, v, pos, width=W,
                            first=first)
    kv_pos = L.cache_positions(pos, W, first, Wl)
    o = _attend(q, kc, vc, kv_pos, pos, p, cfg, tp, split, x.dtype,
                window=_window(cfg, t))
    return x + o, {"k": kc, "v": vc}


def _decode_whole(step, lc, tp, cut):
    """``step(layer cache)`` of a layer that the spmd token step computes
    whole on every rank (an SSD layer whose heads the model axis does not
    divide): the rank's state leaves that ``cut`` cuts over the axis are
    gathered first and its slices of the new state kept."""
    whole = {k: tp.gather(v, cut[k]) if k in cut else v
             for k, v in lc.items()}
    y, st = step(whole)
    return y, {k: v.narrow(cut[k], tp.rank * lc[k].shape[cut[k]],
                           lc[k].shape[cut[k]]) if k in cut else v
               for k, v in st.items()}


def _decode_layer(x, lp, lc, cfg: ModelConfig, t: str, rope, pos, tp=None,
                  cut=None):
    """One layer of the single-token step.  ``tp``: the spmd token step's
    (``decode_step``); ``cut``: its cache leaves' dims cut over the model
    axis."""
    if t == "ssd":
        xn = L.rms_norm(x, lp["ln"], cfg.norm_eps)
        if tp is not None and not tp.splits("ssd_heads"):
            s, st = _decode_whole(lambda c: ssd_mod.ssd_decode_step(
                xn, lp["ssd"], cfg, c), lc, tp, cut)
        else:
            s, st = ssd_mod.ssd_decode_step(xn, lp["ssd"], cfg, lc, tp)
        return x + s, st
    if t == "rec":
        r, st = rglru_mod.rglru_decode_step(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["rec"], cfg, lc, tp)
        return _ffn_out(x + r, lp, cfg, tp=tp), st
    if tp is not None:
        h, st = _decode_attn_tp(x, lp, lc, cfg, t, rope, pos, tp, cut)
        if t == "dec":
            h = _cross_attention(h, lp, lc, cfg, True, tp, cut)
            return _ffn_out(h, lp, cfg, "ln3", tp), st
        return _ffn_out(h, lp, cfg, tp=tp), st
    xin = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _attn_proj(xin, lp["attn"], rope, cfg=cfg)
    kc, vc = L.cache_update(lc["k"], lc["v"], k, v, pos)
    kv_pos = L.cache_positions(pos, kc.shape[1])
    o = L.decode_attention(q, kc, vc, kv_pos, pos, window=_window(cfg, t))
    h = x + _attn_out(o, lp["attn"], x.dtype)
    if t == "dec":
        h = _cross_attention(h, lp, lc, cfg, decode=True)
        return _ffn_out(h, lp, cfg, "ln3"), {"k": kc, "v": vc}
    return _ffn_out(h, lp, cfg), {"k": kc, "v": vc}


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, extras=None,
                gather_specs=None, tp=None, cut=None):
    """One token for every stream.  tokens: (B, 1); pos: (B,) absolute;
    ``extras``: a VLM's ``position_ids`` (3, B, 1), else M-RoPE takes
    ``pos``; ``gather_specs``: see ``_layer_stack``.  Writes each layer's
    ring or state in ``cache`` in place and returns (logits (B, V) f32,
    cache).

    ``tp`` (``launch.steps.make_serve_step_spmd``): a rank's part of the
    tensor-parallel step, on its parameter shards and its cache shard,
    whose leaves ``cut`` (per-layer leaf name -> dim, counted from the
    end) cuts over the model axis: the embedding and head
    vocabulary-parallel (the logits gathered), every layer on the rank's
    heads, ``ff`` slice, SSD heads or LRU channels, attention over the
    rank's slots (``_decode_attn_tp``)."""
    x = embed_tokens(params, cfg, tokens, tp)
    rope = _step_rope(cfg, pos[:, None], extras)
    x = _layer_stack(params, cfg, cache, x,
                     lambda x, lp, lc, t: _decode_layer(x, lp, lc, cfg, t,
                                                        rope, pos, tp, cut),
                     gather_specs)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, 0], tp), cache


def _logits(params, cfg: ModelConfig, x, tp=None):
    """``head_logits`` of ``x`` (B, D) over the whole vocabulary: with
    ``tp`` the rank's vocabulary slice, gathered over the model axis."""
    if tp is None:
        return head_logits(params, cfg, x)
    return tp.gather(head_logits(params, cfg, tp.copy(x), tp), -1)


def _chunk_layer(x, lp, lc, cfg: ModelConfig, t: str, rope, pos, n_tokens,
                 chunk_kernel):
    """One layer of the fused multi-token chunk step."""
    if t == "ssd":
        s, st = ssd_mod.ssd_chunk_step(
            L.rms_norm(x, lp["ln"], cfg.norm_eps), lp["ssd"], cfg, lc,
            n_tokens)
        return x + s, st
    if t == "rec":
        r, st = rglru_mod.rglru_chunk_step(
            L.rms_norm(x, lp["ln1"], cfg.norm_eps), lp["rec"], cfg, lc,
            n_tokens)
        return _ffn_out(x + r, lp, cfg), st
    xin = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _attn_proj(xin, lp["attn"], rope, cfg=cfg)
    o = L.chunk_attention(q, k, v, lc["k"], lc["v"], pos, n_tokens,
                          window=_window(cfg, t), kernel=chunk_kernel)
    kc, vc = L.cache_update_chunk(lc["k"], lc["v"], k, v, pos, n_tokens)
    h = x + _attn_out(o, lp["attn"], x.dtype)
    if t == "dec":
        h = _cross_attention(h, lp, lc, cfg, decode=False)
        return _ffn_out(h, lp, cfg, "ln3"), {"k": kc, "v": vc}
    return _ffn_out(h, lp, cfg), {"k": kc, "v": vc}


def prefill_chunk_step(params, cfg: ModelConfig, spec: CacheViewSpec, cache,
                       tokens, pos, n_tokens, extras=None,
                       chunk_kernel="dense", all_logits=False):
    """One continuous-batching tick as ONE fused multi-token forward.

    tokens: (B, C); pos: (B,) absolute position of tokens[:, 0]; n_tokens:
    (B,) in [0, C] (0 = idle slot).  Every stream's chunk attends jointly
    over [prior ring, intra-chunk causal] (``layers.chunk_attention``;
    ``chunk_kernel="blocked"`` is the CUDA kernel on the card), then the
    ring write keeps the last W active tokens.  Inactive tokens write no
    ring slot; an idle slot's logits row is NEG_INF.  Writes ``cache`` in
    place and returns (last-active-token logits (B, V), cache) — or, with
    ``all_logits``, the per-position logits (B, C, V) with positions at or
    past ``n_tokens`` set to NEG_INF.  SSM and RG-LRU layers run their
    chunk scans from the carried state (``ssd.ssd_chunk_step``,
    ``rglru.rglru_chunk_step``); an inactive token leaves the state as it
    was.  An encoder-decoder layer's chunk then attends over its encoded
    source (``_cross_attention``).  ``extras``: a VLM's ``position_ids``
    (3, B, C), else M-RoPE takes the chunk's positions."""
    B, C = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    q_pos = pos[:, None] + torch.arange(C, device=pos.device)[None, :]
    rope = _step_rope(cfg, q_pos, extras)
    x = _layer_stack(params, cfg, cache, x,
                     lambda x, lp, lc, t: _chunk_layer(
                         x, lp, lc, cfg, t, rope, pos, n_tokens,
                         chunk_kernel))
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


# ---------------------------------------------------------------------------
# Prefill: the full-sequence forward that also builds the decode cache
# ---------------------------------------------------------------------------

def _ring_arrange(kv, W: int):
    """kv: (B, S, Hkv, dh) the prompt's keys or values -> the ring (B, W,
    Hkv, dh) a decode step reads: zero-padded when S < W, else the last W
    positions rolled so that position p sits in slot p % W."""
    S = kv.shape[1]
    if S <= W:
        return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, W - S))
    return torch.roll(kv[:, -W:], shifts=(S - W) % W, dims=1).contiguous()


def _kv_part(kv, cfg: ModelConfig, tp, dim, W=0):
    """The spmd prefill's keys or values (B, S, ·, dh) of the rank's kv
    heads (where the specs cut the heads) in the rank's part of the cache
    layout: ring-arranged to ``W`` (0: the source frames, as they are),
    every kv head gathered, then the rank's slice of ``dim`` (None: the
    whole) — one layer at a time."""
    if W:
        kv = _ring_arrange(kv, W)
    if tp.splits("heads"):
        kv = tp.all_kv_heads(kv, cfg.n_heads, cfg.n_kv_heads)
    if dim is not None:
        n = kv.shape[dim] // tp.size
        kv = kv.narrow(dim, tp.rank * n, n)
    # a copy: a slice of the gathered heads (or a window slice of one
    # stream, which is contiguous) would keep all of them alive
    return kv.clone(memory_format=torch.contiguous_format)


_SPLITS = {"ssd": "ssd_heads", "rec": "lru"}


def _state_to_cache(cfg: ModelConfig, st, lt: str, max_len: int, tp=None,
                    cut=None):
    """One layer's prefill state in its decode-cache form: attention keys
    and values ring-arranged to the layer's cache width (a hybrid's local
    window folded in by ``_attn_cache_width``); recurrent and SSD states
    as they are, but a conv tail of a prompt shorter than the conv's K-1
    inputs front-padded with the zeros a fresh state holds.  ``tp``,
    ``cut``: the spmd prefill's — the rank's part of each leaf as ``cut``
    cuts it (``_kv_part``; a recurrent or SSD layer computed on the
    rank's shards holds it already, one computed whole is sliced)."""
    if lt == "attn":
        W = _attn_cache_width(cfg, max_len)
        if tp is not None:
            return {n: _kv_part(st[n], cfg, tp, cut.get(n), W)
                    for n in ("k", "v")}
        return {"k": _ring_arrange(st["k"], W), "v": _ring_arrange(st["v"], W)}
    if tp is not None and not tp.splits(_SPLITS[lt]):
        st = {k: v.narrow(cut[k], tp.rank * (v.shape[cut[k]] // tp.size),
                          v.shape[cut[k]] // tp.size).clone()
              if k in cut else v for k, v in st.items()}
    K = cfg.conv_width
    return {k: (torch.nn.functional.pad(v, (0, 0, K - 1 - v.shape[1], 0))
                if k.startswith("conv") and v.shape[1] < K - 1
                else v.contiguous())
            for k, v in st.items()}


def prefill(params, cfg: ModelConfig, tokens, extras=None, *, max_len: int,
            gather_specs=None, tp=None, cut=None):
    """Process whole prompts: (logits (B, V) after the last token, the
    decode cache shaped like ``init_cache(cfg, B, max_len)``).  tokens:
    (B, S); ``extras`` the forward's (a VLM's ``vision_embeds`` and
    ``position_ids``), or an encoder-decoder model's ``frame_embeds``
    (``encdec_prefill``).  The forward runs every layer over the whole
    sequence — flash attention, the SSD scan and the RG-LRU scan through
    their kernels on the card — and ring-arranges each layer's keys and
    values as the layer finishes, so a windowed cache never holds (L, B,
    S, ...).  ``gather_specs`` goes to the forward (the per-layer gather
    points, ``transformer._wsc_tree``).  ``tp``, ``cut``
    (``launch.steps.make_prefill_spmd``): the rank's part of the
    tensor-parallel forward, whose cache comes out as the rank's shard:
    each leaf's dims that ``cut`` names cut over the model axis, laid out
    layer by layer (``_state_to_cache``)."""
    extras = extras or {}
    if cfg.family == "encdec":
        return encdec_prefill(params, cfg, extras["frame_embeds"], tokens,
                              max_len=max_len, gather_specs=gather_specs,
                              tp=tp, cut=cut)
    x, states, _ = forward(params, cfg, tokens, extras, return_states=True,
                           state_fn=lambda st, t: _state_to_cache(
                               cfg, st, t, max_len, tp, cut),
                           gather_specs=gather_specs, tp=tp)
    with torch.no_grad():
        logits = _logits(params, cfg, x[:, -1], tp)
    return logits, states


def encdec_prefill(params, cfg: ModelConfig, frame_embeds, tokens, *,
                   max_len: int, gather_specs=None, tp=None, cut=None):
    """Encode the source ``frame_embeds`` (B, S_src, D), run the decoder
    over the target prefix ``tokens`` (B, S), and build the decode cache
    (``init_cache(cfg, B, max_len, S_src)``'s layout): each layer's
    cross-attention keys and values, and its self-attention keys and
    values ring-arranged to ``max_len`` as the layer finishes.  Returns
    (logits (B, V) after the last token, cache).  ``tp``, ``cut``: as
    ``prefill``'s (the cross keys and values cut on their source axis)."""
    def state_fn(st):
        if tp is not None:
            return {n: _kv_part(st[n], cfg, tp, cut.get(n),
                                max_len if n in ("k", "v") else 0)
                    for n in ("k", "v", "ck", "cv")}
        return {"k": _ring_arrange(st["k"], max_len),
                "v": _ring_arrange(st["v"], max_len),
                "ck": st["ck"], "cv": st["cv"]}

    with torch.no_grad():
        enc_out = encode(params, cfg, frame_embeds, gather_specs, tp)
        x, states = decoder_forward(params, cfg, tokens, enc_out,
                                    return_states=True, state_fn=state_fn,
                                    gather_specs=gather_specs, tp=tp)
        logits = _logits(params, cfg, x[:, -1], tp)
    return logits, {"cross_k": states["ck"], "cross_v": states["cv"],
                    "self": {"k": states["k"], "v": states["v"]}}
