"""Three-term roofline cost model — the controller's objective function.

For a (ModelConfig, ShapeConfig, Layout) this estimates, per step:

  compute_s  — FLOPs / (chips * peak)
  memory_s   — HBM traffic / (chips * hbm_bw)
  ici/dcn_s  — collective bytes / link bandwidth, split by link class
               (intra-group / cross-group / cross-pod)

and the byte counters the ARCAS profiler feeds to Algorithm 1
(local_bytes / remote_bytes / dcn_bytes), plus the per-replica working set
for the capacity guard (the Fig. 5 "does it fit in s groups' HBM" test).

These are *napkin* numbers for placement decisions and the paper-figure
simulations, priced with the data-sheet constants of ``topology.py``;
measured times come only from runs on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.layout import Layout


@dataclasses.dataclass(frozen=True)
class StepCost:
    compute_s: float
    memory_s: float
    ici_local_s: float           # intra-group collective time
    ici_remote_s: float          # cross-group collective time
    dcn_s: float
    local_bytes: float           # per-chip HBM bytes (counter feed)
    remote_bytes: float          # per-chip cross-group bytes (counter feed)
    dcn_bytes: float
    working_set: float           # per-replica resident bytes
    fits: bool

    @property
    def collective_s(self) -> float:
        return self.ici_local_s + self.ici_remote_s + self.dcn_s

    @property
    def total_s(self) -> float:
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def overlap_s(self) -> float:
        """Perfect-overlap lower bound (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


# ---------------------------------------------------------------------------
# FLOPs / bytes primitives
# ---------------------------------------------------------------------------

def fwd_flops_per_token(cfg: ModelConfig, seq_len: int, *,
                        decode: bool = False) -> float:
    """Forward FLOPs per token (matmuls + attention/ssd terms)."""
    D, F = cfg.d_model, cfg.d_ff
    flops = 0.0
    kv_span = min(seq_len, cfg.window) if cfg.window else seq_len
    for lt in cfg.layer_types():
        if lt == "attn":
            Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            flops += 2 * D * (Hq + 2 * Hkv) * dh          # qkv proj
            flops += 2 * Hq * dh * D                      # out proj
            span = kv_span if decode else kv_span / 2      # causal avg
            flops += 2 * 2 * Hq * dh * span               # qk + pv
            if cfg.n_experts:
                mult = 3 if cfg.activation in ("swiglu", "gelu_glu") else 2
                flops += 2 * mult * D * F * cfg.top_k     # active experts
                flops += 2 * D * cfg.n_experts            # router
            else:
                mult = 3 if cfg.activation in ("swiglu", "gelu_glu",
                                               "relu_glu") else 2
                flops += 2 * mult * D * F
        elif lt == "rec":
            W = cfg.lru_width
            flops += 2 * D * W * 2 + 2 * W * W * 2 + 2 * W * D   # projections+gates
            mult = 3 if cfg.activation in ("swiglu", "gelu_glu") else 2
            flops += 2 * mult * D * F
        elif lt == "ssd":
            di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            GN = cfg.ssm_groups * N
            flops += 2 * D * (2 * di + 2 * GN + H)        # in projections
            flops += 2 * di * D                           # out proj
            Q = cfg.ssd_chunk
            if decode:
                flops += 2 * H * cfg.ssm_head_dim * N * 2  # state update + C.h
            else:
                # intra-chunk QxQ scores + two (Q,N)x(N,P) products per token
                flops += 2 * N * Q + 2 * 2 * N * cfg.ssm_head_dim * H / max(H, 1) * H
    # embedding gather is O(D); head matmul:
    head_tokens = 1.0  # per token
    flops += 2 * D * cfg.vocab * head_tokens
    if cfg.family == "encdec":
        flops *= 1.0  # enc+dec both included via layer_types? encdec uses n_layers
        # add cross-attention per decoder layer
        Hq, dh = cfg.n_heads, cfg.head_dim
        flops += cfg.dec_layers * (2 * D * Hq * dh * 3 + 2 * 2 * Hq * dh *
                                   (seq_len / 2))
    return flops


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        remat_factor = {"none": 3.0, "block": 4.0, "full": 4.0}[cfg.remat]
        return remat_factor * fwd_flops_per_token(cfg, shape.seq_len) * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return fwd_flops_per_token(cfg, shape.seq_len) * tokens
    # decode: one token per stream against a seq_len-deep cache
    return fwd_flops_per_token(cfg, shape.seq_len, decode=True) * shape.global_batch


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The 6*N*D convention (6*N_active*D for MoE) for the §Roofline ratio."""
    from repro_torch.models.params import n_params
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> float:
    """Decode-state bytes for ``batch`` streams at context shape.seq_len."""
    itemsize = 2  # bf16
    total = 0.0
    S = shape.seq_len
    for lt in cfg.layer_types():
        if lt == "attn":
            W = min(S, cfg.window) if cfg.window else S
            if cfg.family == "hybrid":
                W = min(S, cfg.local_window)
            total += 2 * batch * W * cfg.n_kv_heads * cfg.head_dim * itemsize
        elif lt == "rec":
            total += batch * cfg.lru_width * 4
        elif lt == "ssd":
            total += batch * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    if cfg.family == "encdec":
        total += 2 * cfg.dec_layers * batch * 4096 * cfg.n_kv_heads * \
            cfg.head_dim * itemsize  # cross-attn KV at S_src=4096
    return total


def kv_token_bytes(cfg: ModelConfig) -> float:
    """Ring-cache bytes ONE stream commits per context token (the slope of
    ``kv_cache_bytes`` in ``seq_len`` below the window cap)."""
    itemsize = 2  # bf16
    total = 0.0
    for lt in cfg.layer_types():
        if lt == "attn":
            total += 2 * cfg.n_kv_heads * cfg.head_dim * itemsize
    return total


def kv_state_bytes(cfg: ModelConfig) -> float:
    """Per-stream decode-state bytes with NO token dependence (recurrent /
    SSD states, enc-dec cross-attention KV) — the intercept of
    ``kv_cache_bytes``."""
    total = 0.0
    for lt in cfg.layer_types():
        if lt == "rec":
            total += cfg.lru_width * 4
        elif lt == "ssd":
            total += cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    if cfg.family == "encdec":
        total += 2 * cfg.dec_layers * 4096 * cfg.n_kv_heads * cfg.head_dim * 2
    return total


def kv_spill_bytes(cfg: ModelConfig, pages: int, block_tokens: int,
                   with_state: bool = True) -> float:
    """Host bytes ONE spilled stream parks in the swap tier: its used ring
    pages (``pages`` pages of ``block_tokens`` tokens) plus its per-stream
    state.  This is also the D2H+H2D traffic one spill/restore cycle costs
    — the number to weigh against ``recompute`` FLOPs when deciding
    whether swapping beats restart-eviction."""
    return (pages * block_tokens * kv_token_bytes(cfg)
            + (kv_state_bytes(cfg) if with_state else 0.0))


def kv_transfer_seconds(n_bytes: float, bw: float) -> float:
    """Wall-clock seconds one swap-tier transfer of ``n_bytes`` occupies
    the host link at bandwidth ``bw`` (``HardwareSpec.d2h_bw`` /
    ``h2d_bw``).  This is the window the async transfer engine has to hide
    behind decode ticks: a spill is "free" when the victim's line wait
    exceeds ``kv_transfer_seconds(kv_spill_bytes(...), d2h_bw)``."""
    return float(n_bytes) / max(float(bw), 1.0)


def kv_spill_transfer_seconds(cfg: ModelConfig, pages: int,
                              block_tokens: int, bw: float,
                              with_state: bool = True) -> float:
    """One spill (or restore) priced on the host link: the swap-tier
    payload of ``kv_spill_bytes`` moved at ``bw``."""
    return kv_transfer_seconds(
        kv_spill_bytes(cfg, pages, block_tokens, with_state), bw)


def kv_bypass_floor_bytes(cfg: ModelConfig, head_need_pages: int,
                          block_tokens: int,
                          with_state: bool = False) -> float:
    """Device bytes a size-aware bypass grant must leave FREE for the
    blocked head of the admission wait line — the bypass-safety bound.

    The head's provable need is a page count (its next grow chunk, a
    whole-table migrate, or its spill-restore footprint); this prices it
    at the same per-token ring rate as :func:`kv_spill_bytes` — by
    construction: a floor large enough to restore the head from the swap
    tier is large enough for every cheaper regrant path.  ``with_state``
    adds the per-stream state slot a spilled hybrid head re-takes on
    restore.  A bypass is safe only when the granting domain keeps this
    floor free, so the head's time-to-grant is never delayed."""
    return (max(head_need_pages, 0) * block_tokens * kv_token_bytes(cfg)
            + (kv_state_bytes(cfg) if with_state else 0.0))


def spec_rejected_bytes(cfg: ModelConfig, rejected_tokens: int) -> float:
    """HBM bytes the speculative verify forward moved for draft tokens
    greedy acceptance then threw away — the honest cost of optimism.

    Per rejected token: its activation row streamed through every layer
    (read + write of a ``d_model`` bf16 vector per layer) plus the ring-KV
    write the masked cache update committed before rollback restored the
    page (``kv_token_bytes``).  Napkin bound like the rest of this module:
    weights stream once per CHUNK regardless of width, so the marginal
    token pays only its activation and cache traffic."""
    act = 2.0 * cfg.d_model * len(cfg.layer_types()) * 2.0
    return rejected_tokens * (act + kv_token_bytes(cfg))


def spec_rollback_bytes(cfg: ModelConfig, ckpt_pages: int,
                        restored_pages: int, block_tokens: int, *,
                        ckpts: int = 0, rollbacks: int = 0) -> float:
    """Host round-trip bytes the optimistic-commit rollback protocol pays:
    every speculative tick snapshots its write-touched pages (+ state
    slot) D2H (``ckpt_pages`` over ``ckpts`` checkpoints) and every
    partial accept restores them H2D (``restored_pages`` over
    ``rollbacks``), priced with the same per-page formula as the swap
    tier."""
    return (kv_spill_bytes(cfg, ckpt_pages, block_tokens, with_state=False)
            + ckpts * kv_state_bytes(cfg)
            + kv_spill_bytes(cfg, restored_pages, block_tokens,
                             with_state=False)
            + rollbacks * kv_state_bytes(cfg))


def kv_dedup_bytes(cfg: ModelConfig, shared_extra_refs: int,
                   block_tokens: int) -> float:
    """Ring-cache bytes prefix sharing keeps OFF the device right now:
    every table->page reference beyond a shared page's first holder
    (``shared_extra_refs``) is a page-sized footprint served without a
    resident copy of its own.  Logical KV bytes = resident + this; the
    benchmark reports both so capacity claims stay honest."""
    return shared_extra_refs * block_tokens * kv_token_bytes(cfg)


def prefill_chunk_score_bytes(cfg: ModelConfig, chunk_tokens: int,
                              max_len: int = 0, kernel: str = "dense",
                              block_q: int = 32, block_kv: int = 32) -> float:
    """f32 attention-score transient ONE stream materializes in the
    PARALLEL (fused) chunk forward.

    ``kernel="dense"`` (the einsum reference): per query head, TWO live
    (C, W + C) buffers — the joint score block over [W-slot prior ring,
    intra-chunk causal] and its softmax probabilities (the per-source
    partial scores fuse into the concatenation).  ``kernel="blocked"``
    (the Pallas online-softmax ring kernel): the same two buffers but
    clipped to ONE (block_q, block_kv) tile — the live transient per grid
    step, independent of W and C once both exceed the block sizes.

    Layers run under ``lax.scan``, so only the widest layer's buffers are
    live at once.  Enc-dec cross-attention runs through BLOCKED (flash)
    attention either way, so it adds one (C, block_kv) score block — never
    the full (C, S_src) matrix (the S_src=4096 convention caps the block).
    Zero for pure-state models and for the scan path (whose per-token
    score rows are negligible)."""
    if kernel not in ("dense", "blocked"):
        raise ValueError(f"unknown chunk kernel {kernel!r}")
    if max_len:
        chunk_tokens = min(chunk_tokens, max_len)
    C = float(chunk_tokens)
    hybrid = cfg.family == "hybrid"
    per_layer = [0.0]
    for lt in cfg.layer_types():
        if lt != "attn":
            continue
        w = cfg.local_window if hybrid else cfg.window
        W = min(max_len, w) if (w and max_len) else (w or max_len)
        if kernel == "blocked":
            b = (2.0 * cfg.n_heads * min(block_q, C)
                 * min(block_kv, W + C) * 4.0)
        else:
            b = 2.0 * cfg.n_heads * C * (W + C) * 4.0
        if cfg.family == "encdec":
            b += cfg.n_heads * C * min(cfg.attn_block_kv, 4096) * 4.0
        per_layer.append(b)
    return max(per_layer)


def prefill_chunk_bytes(cfg: ModelConfig, chunk_tokens: int,
                        max_len: int = 0, mode: str = "scan",
                        kernel: str = "dense") -> float:
    """Byte-accurate transient footprint of ONE chunked-prefill step: the
    ring KV written for ``chunk_tokens`` new tokens plus the per-stream
    state carried between chunks.  This bounds the outside-the-pool prefill
    buffer regardless of prompt length — the number to compare against the
    ``kv_cache_bytes(prompt)`` single-stream cache that whole-prompt
    prefill materializes before scattering.  ``mode="parallel"`` adds the
    fused path's attention-score transient
    (``prefill_chunk_score_bytes``) for the given ``kernel``, so chunk-size
    sweeps compare honest footprints across compiled paths AND kernels."""
    if max_len:
        chunk_tokens = min(chunk_tokens, max_len)
    base = chunk_tokens * kv_token_bytes(cfg) + kv_state_bytes(cfg)
    if mode == "parallel":
        base += prefill_chunk_score_bytes(cfg, chunk_tokens, max_len,
                                          kernel=kernel)
    return base


# ---------------------------------------------------------------------------
# Full step cost
# ---------------------------------------------------------------------------

def estimate(cfg: ModelConfig, shape: ShapeConfig, layout: Layout,
             *, optimizer_bytes_per_param: float = 8.0,
             chiplet_agnostic: bool = False) -> StepCost:
    """``chiplet_agnostic=True`` models a NUMA-aware-but-chiplet-blind
    runtime (the RING/Shoal baselines): same (replicas x shards)
    factorization, but device order stripes TP rings across chiplet groups,
    so ALL tensor-parallel traffic crosses group boundaries."""
    from repro_torch.models.params import param_bytes

    t = layout.topology
    hw = t.hw
    chips = t.total_chips
    m = layout.model_degree
    R = layout.replicas
    pbytes = param_bytes(cfg)
    n_par = pbytes / 2  # bf16 params

    flops = step_flops(cfg, shape)
    compute_s = flops / (chips * hw.peak_flops_bf16)

    # --- HBM traffic per chip ---
    if shape.kind == "train":
        # params read + grad write + optimizer read/write + activations
        act = 2.0 * shape.global_batch * shape.seq_len * cfg.d_model * \
            cfg.n_layers * 2 / chips
        hbm = (pbytes / m) * 3 + (n_par * optimizer_bytes_per_param) / m + act
    elif shape.kind == "prefill":
        act = 2.0 * shape.global_batch * shape.seq_len * cfg.d_model * \
            cfg.n_layers * 2 / chips
        hbm = pbytes / m + act
    else:
        batch_per_replica = max(1, shape.global_batch // R)
        kv = kv_cache_bytes(cfg, shape, batch_per_replica) / m
        hbm = pbytes / m + kv
    memory_s = hbm / hw.hbm_bw

    # --- collectives ---
    tokens_per_replica = (shape.global_batch // max(R, 1)) * (
        1 if shape.is_decode else shape.seq_len)
    tokens_per_replica = max(tokens_per_replica, 1)
    act_bytes = tokens_per_replica * cfg.d_model * 2

    # TP: ~2 all-reduces of the activations per layer (Megatron pattern)
    tp_bytes_per_chip = (cfg.n_layers * 2 * 2 * act_bytes * (m - 1) / m)
    tp_cross = layout.spread_rate > 1 or chiplet_agnostic
    ici_local_b = 0.0 if tp_cross else tp_bytes_per_chip
    ici_remote_b = tp_bytes_per_chip if tp_cross else 0.0

    dcn_b = 0.0
    dp_bytes_per_chip = 0.0
    if shape.kind == "train" and R > 1:
        # DP grad all-reduce over replicas: always crosses groups
        dp_bytes_per_chip = 2 * (pbytes / m) * (R - 1) / R
        if t.n_pods > 1:
            # hierarchical: intra-pod reduce-scatter + cross-pod exchange
            dcn_b = 2 * (pbytes / m) / t.n_pods
            dp_bytes_per_chip *= (1 - 1 / t.n_pods)
        ici_remote_b += dp_bytes_per_chip

    # latency floors (the Fig. 3 hierarchy): every TP collective pays the
    # link-class latency — decode steps are small-message latency-bound,
    # which is what makes compact placement win for small working sets
    n_tp_coll = 2 * cfg.n_layers
    tp_lat = n_tp_coll * (t.hw.lat_intra_pod if tp_cross
                          else t.hw.lat_intra_group)
    ici_local_s = ici_local_b / t.bandwidth("intra_group") + \
        (0.0 if tp_cross else tp_lat)
    ici_remote_s = ici_remote_b / t.bandwidth("intra_pod") + \
        (tp_lat if tp_cross else 0.0)
    dcn_s = dcn_b / t.bandwidth("cross_pod")

    # --- capacity ---
    if shape.kind == "train":
        ws = pbytes + n_par * (2.0 + optimizer_bytes_per_param)  # p+g+opt
        ws += 2.0 * (shape.global_batch / max(R, 1)) * shape.seq_len * \
            cfg.d_model * 2 * (2 if cfg.remat == "none" else 0.3) * \
            math.sqrt(cfg.n_layers)
    else:
        bpr = max(1, shape.global_batch // max(R, 1))
        ws = pbytes + kv_cache_bytes(cfg, shape, bpr)

    return StepCost(
        compute_s=compute_s, memory_s=memory_s,
        ici_local_s=ici_local_s, ici_remote_s=ici_remote_s, dcn_s=dcn_s,
        local_bytes=hbm + ici_local_b,
        remote_bytes=ici_remote_b,
        dcn_bytes=dcn_b,
        working_set=ws,
        fits=layout.fits(ws),
    )


def best_layout(cfg: ModelConfig, shape: ShapeConfig, layouts) -> Layout:
    """argmin modeled step time over feasible layouts (model_guided policy)."""
    feasible = [(estimate(cfg, shape, l), l) for l in layouts]
    ok = [(c, l) for c, l in feasible if c.fits]
    pool = ok or feasible
    return min(pool, key=lambda cl: cl[0].overlap_s)[1]
