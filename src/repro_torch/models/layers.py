"""Shared layers of the serving path: norms, RoPE, MLPs, decode and chunk
attention, and the ring-buffer KV cache helpers.

Layouts follow the JAX package at every public function — attention
tensors are (B, S, H, dh), ring caches (B, W, Hkv, dh) — so the tests
compare like with like.  Functions are pure: they return new tensors and
leave their inputs untouched (callers that own a buffer may copy the
result back in place).

Precision follows the JAX package's ``preferred_element_type``: norms,
RoPE, softmax and attention scores run in float32; a projection runs in
its input dtype (a bf16 matmul accumulates in f32 and rounds once, which
is what the JAX einsum followed by ``astype`` does).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops, ref

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin tables (..., S, head_dim//2), f32."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, dh); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_apply(x, params, activation: str):
    """params: {wi: (D, 2, F) for GLU or (D, F), wo: (F, D)}."""
    if activation in ("swiglu", "gelu_glu", "relu_glu"):
        D, _, Fd = params["wi"].shape
        h = (x @ params["wi"].reshape(D, 2 * Fd)).float()
        gate, up = h[..., :Fd], h[..., Fd:]
        if activation == "swiglu":
            act = F.silu(gate)
        elif activation == "gelu_glu":
            act = F.gelu(gate, approximate="tanh")
        else:
            act = F.relu(gate)
        h = (act * up).to(x.dtype)
    else:
        h = (x @ params["wi"]).float()
        if activation == "squared_relu":
            h = F.relu(h).square()
        elif activation == "gelu":
            h = F.gelu(h, approximate="tanh")
        else:
            raise ValueError(activation)
        h = h.to(x.dtype)
    return (h @ params["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, kv_positions, q_pos, *,
                     window=0, softcap=0.0):
    """Single-token attention over a (ring-buffer) cache.

    q: (B, 1, Hq, dh); caches: (B, W, Hkv, dh); kv_positions: (B, W) actual
    absolute positions stored in each slot (negative = empty); q_pos: (B,).
    """
    B, _, Hq, dh = q.shape
    _, W, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * dh ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (kv_positions >= 0) & (kv_positions <= q_pos[:, None])
    if window:
        valid &= kv_positions > (q_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, dh).to(q.dtype)


def chunk_attention(q, k_new, v_new, k_cache, v_cache, pos, n_tokens, *,
                    window=0, softcap=0.0, kernel="dense"):
    """Multi-token chunk attention over a ring cache.

    q/k_new/v_new: (B, C, H*, dh) the chunk's projections; k_cache/v_cache:
    (B, W, Hkv, dh) the ring BEFORE the chunk is written; pos: (B,)
    absolute position of chunk token 0; n_tokens: (B,) in [0, C].  Query
    t attends jointly over [prior ring, chunk keys t' <= t] under one
    softmax, with ring eviction (``kv > q - W``) applied to both parts.

    ``kernel="blocked"`` goes through ``ops.ring_chunk_attention`` (the
    hand-written CUDA kernel for tensors on the card); "dense" is the plain
    masked softmax of ``ref.py``.  Both return 0 for a row with no visible
    key (the JAX dense path returns a discarded uniform row there).
    """
    if kernel == "blocked":
        return ops.ring_chunk_attention(q, k_new, v_new, k_cache, v_cache,
                                        pos, n_tokens, window=window,
                                        softcap=softcap)
    if kernel != "dense":
        raise ValueError(f"unknown chunk kernel {kernel!r}: "
                         "expected 'dense' or 'blocked'")
    return ref.ring_chunk_attention_ref(q, k_new, v_new, k_cache, v_cache,
                                        pos, n_tokens, window=window,
                                        softcap=softcap)


# ---------------------------------------------------------------------------
# Ring-buffer KV cache helpers
# ---------------------------------------------------------------------------

def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write one token at ring slot pos % W, per batch element.

    caches: (B, W, Hkv, dh); k_new/v_new: (B, 1, Hkv, dh); pos: (B,).
    """
    B, W = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    slot = pos.long() % W
    k_out, v_out = k_cache.clone(), v_cache.clone()
    k_out[rows, slot] = k_new[:, 0]
    v_out[rows, slot] = v_new[:, 0]
    return k_out, v_out


def cache_update_chunk(k_cache, v_cache, k_new, v_new, pos, n_tokens):
    """Write up to C tokens per stream at ring slots (pos+t) % W, masked.

    Tokens past a stream's ``n_tokens`` leave their slot untouched.  For
    C > W several chunk tokens map to one slot and the LAST active one
    wins, as in sequential stepping — computed as a per-slot GATHER of that
    token, never a scatter with duplicate indices (whose write order is
    unspecified on the card).
    """
    B, C, Hkv, dh = k_new.shape
    W = k_cache.shape[1]
    pos = pos.long()[:, None]
    n = n_tokens.long()[:, None]
    s_idx = torch.arange(W, device=k_cache.device)[None, :]    # (1, W)
    t0 = (s_idx - pos) % W                                     # (B, W)
    # largest active chunk token landing on each slot: t0, t0+W, ...
    t_star = t0 + W * torch.div(n - 1 - t0, W, rounding_mode="floor")
    written = (t0 < n)[:, :, None, None]
    src = t_star.clamp(0, C - 1)[:, :, None, None].expand(B, W, Hkv, dh)
    k_out = torch.where(written, torch.gather(k_new, 1, src), k_cache)
    v_out = torch.where(written, torch.gather(v_new, 1, src), v_cache)
    return k_out, v_out


def cache_positions(pos, W):
    """Absolute position stored at each ring slot after writing ``pos``.

    pos: (B,) current (just-written) position.  Slot s holds the largest
    p <= pos with p % W == s; slots never written hold negative values.
    """
    slots = torch.arange(W, device=pos.device)
    p = pos.long()[:, None]
    return p - ((p - slots[None, :]) % W)
