"""Shared layers of the serving path: norms, RoPE and M-RoPE, MLPs,
decode and chunk attention, and the ring-buffer KV cache helpers.

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

from repro_torch.kernels import dry
from repro_torch.kernels.flash_attention import ops, ref

NEG_INF = -1e30


def records_grad(x, tree) -> bool:
    """Whether autograd records a function of ``x`` and the tensors of
    ``tree`` (a nested dict): only then has a recomputation in the
    backward (``torch.utils.checkpoint``) anything to spare.  A serving
    step's weights require no gradient, so it calls its blocks directly
    (a first checkpoint also imports ``torch._dynamo``, seconds of host
    time)."""
    if not torch.is_grad_enabled():
        return False
    todo = [x, tree]
    while todo:
        t = todo.pop()
        if isinstance(t, dict):
            todo.extend(t.values())
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


# ---------------------------------------------------------------------------
# Projections with float32 output
# ---------------------------------------------------------------------------

def _mm_f32(a, b):
    """a (M, K) @ b (K, N) -> (M, N) float32 from operands of one type, or
    batched, a (E, M, K) @ b (E, K, N) -> (E, M, N), with no float32 copy
    of either on the card: cuBLAS's bf16 -> f32 GEMM (``out_dtype``)
    there (and on the dry run's fake ``meta`` tensors, ``kernels/dry.py``);
    the CPU upcasts, which computes the same function (products of bf16
    values are exact in float32)."""
    if a.dtype == torch.float32 or not dry.on_card(a):
        return a.float() @ b.float()
    if a.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)


GRAD_BLOCK = 16384      # weight-gradient columns summed at a time


class _MatmulF32(torch.autograd.Function):
    """x (M, K) @ w (K, N) -> float32, or the batched x (E, M, K) @ w (E,
    K, N), as a JAX einsum with
    ``preferred_element_type=float32`` computes it: the product is never
    rounded to the operands' type, and the float32 cotangent is contracted
    in float32.  On the card the backward splits the float32 cotangent
    into two bf16 parts (hi + lo, 16 of float32's 24 mantissa bits) and
    sums their two bf16 -> f32 GEMMs, so no float32 copy of the weight
    (the (V, D) embedding, for the output head) is made; the weight's
    gradient is summed in float32 ``GRAD_BLOCK`` columns at a time, so its
    float32 temporaries stay at one block's size (a whole (D, V) one is
    4.2 GB at recurrentgemma's vocabulary of 256,000)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.dtype == torch.float32 or not dry.on_card(g):
            parts = (g,)
        else:
            hi = g.to(x.dtype)
            parts = (hi, (g - hi).to(x.dtype))    # f32 - bf16: no f32 copy
        wt = w.transpose(-1, -2)
        gx = _mm_f32(parts[0], wt)
        for p in parts[1:]:
            gx += _mm_f32(p, wt)
        gw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        # a batched product's weight gradient one batch entry at a time
        batched = w.dim() == 3
        for e in range(w.shape[0] if batched else 1):
            xe, ge = (x[e], gw[e]) if batched else (x, gw)
            pe = [p[e] for p in parts] if batched else parts
            for c0 in range(0, ge.shape[1], GRAD_BLOCK):
                cols = slice(c0, c0 + GRAD_BLOCK)
                acc = _mm_f32(xe.t(), pe[0][:, cols])
                for p in pe[1:]:
                    acc += _mm_f32(xe.t(), p[:, cols])
                ge[:, cols] = acc
        return gx.to(x.dtype), gw


def matmul_f32(x, w):
    """x (..., K) @ w (K, N) -> float32 (..., N) from operands of one type,
    differentiable; see ``_MatmulF32``."""
    lead = x.shape[:-1]
    return _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w) \
        .reshape(*lead, w.shape[-1])


def bmm_f32(x, w):
    """x (E, M, K) @ w (E, K, N) -> float32 (E, M, N) from operands of one
    type, differentiable: one product a batch entry (an expert); see
    ``_MatmulF32``."""
    return _MatmulF32.apply(x, w)


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


def mrope_tables(position_ids, head_dim: int, theta: float, sections):
    """M-RoPE (Qwen2-VL): position_ids (3, ..., S) int, the temporal,
    height and width components; ``sections`` sum to head_dim // 2 ->
    cos/sin tables (..., S, head_dim // 2), float32.  Component c gives
    its angle to ``sections[c]`` frequency slots, in order; with three
    equal components this is ``rope_tables``.  No host data reaches the
    device, so a CUDA graph can hold it."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=position_ids.device) / half)
    parts, lo = [], 0
    for c, n in enumerate(sections):
        parts.append(position_ids[c].float()[..., None] * freq[lo:lo + n])
        lo += n
    ang = torch.cat(parts, dim=-1)
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

GLU = ("swiglu", "gelu_glu", "relu_glu")


def ffn_activation(h, activation: str, dtype):
    """The feed-forward activation of the float32 ``wi`` product ``h``
    (GLU: gate and up halves along the last axis), rounded to
    ``dtype``."""
    if activation in GLU:
        gate, up = h.chunk(2, dim=-1)
        if activation == "swiglu":
            act = F.silu(gate)
        elif activation == "gelu_glu":
            act = F.gelu(gate, approximate="tanh")
        else:
            act = F.relu(gate)
        return (act * up).to(dtype)
    if activation == "squared_relu":
        h = F.relu(h).square()
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(activation)
    return h.to(dtype)


def mlp_apply(x, params, activation: str, tp=None):
    """params: {wi: (D, 2, F) for GLU or (D, F), wo: (F, D)}.  The ``wi``
    product is float32 (``matmul_f32``, as the JAX einsum's
    ``preferred_element_type``), so the gate and up pre-activations are
    never rounded to ``x.dtype``; the activation's output is, and ``wo``
    runs in ``x.dtype``.  ``tp`` (``tensor_parallel``), where the specs
    cut ``ff`` over the model axis: ``wi`` column-parallel and ``wo``
    row-parallel on the rank's ``ff`` slice, the partial outputs summed
    over the axis."""
    split = tp is not None and tp.splits("ff")
    if split:
        x = tp.copy(x)
    wi = params["wi"]
    h = matmul_f32(x, wi.reshape(wi.shape[0], -1))
    y = (ffn_activation(h, activation, x.dtype) @ params["wo"]).to(x.dtype)
    return tp.reduce(y) if split else y


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _decode_scores(q, k_cache, kv_positions, q_pos, window, softcap):
    """(scores (B, Hkv, G, W) float32, NEG_INF where a slot is not
    visible; the visible slots (B, 1, 1, W)) of a single-token query."""
    B, _, Hq, dh = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * dh ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (kv_positions >= 0) & (kv_positions <= q_pos[:, None])
    if window:
        valid &= kv_positions > (q_pos[:, None] - window)
    valid = valid[:, None, None, :]
    return torch.where(valid, s, NEG_INF), valid


def decode_attention(q, k_cache, v_cache, kv_positions, q_pos, *,
                     window=0, softcap=0.0):
    """Single-token attention over a (ring-buffer) cache.

    q: (B, 1, Hq, dh); caches: (B, W, Hkv, dh); kv_positions: (B, W) actual
    absolute positions stored in each slot (negative = empty); q_pos: (B,).
    """
    B, _, Hq, dh = q.shape
    s, _ = _decode_scores(q, k_cache, kv_positions, q_pos, window, softcap)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, dh).to(q.dtype)


def decode_attention_parts(q, k_cache, v_cache, kv_positions, q_pos, *,
                           window=0, softcap=0.0):
    """``decode_attention`` over a part of the ring (its slots, with their
    absolute positions), before the normalisation: (running max (B, Hkv,
    G), sum (B, Hkv, G), unnormalised output (B, Hkv, G, dh)), float32.  A
    part with no visible slot gives max NEG_INF, sum 0 and output 0, so it
    adds no weight when the parts are combined."""
    s, valid = _decode_scores(q, k_cache, kv_positions, q_pos, window,
                              softcap)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return m, p.sum(dim=-1), o


def split_decode_attention(q, k_cache, v_cache, kv_positions, q_pos, tp, *,
                           window=0, softcap=0.0):
    """``decode_attention`` over a ring whose slots are cut over ``tp``'s
    axis: each rank scores its slots (``decode_attention_parts``), the
    ranks' maxima are reduced, then their sums and outputs rescaled to
    that maximum and summed: two all-reduces over the axis.  ``q`` holds
    every head; a query with no visible slot on any rank gives 0."""
    B, _, Hq, dh = q.shape
    m, l, o = decode_attention_parts(q, k_cache, v_cache, kv_positions,
                                     q_pos, window=window, softcap=softcap)
    scale = torch.exp(m - tp.pmax(m))
    both = tp.reduce(torch.cat([(l * scale)[..., None],
                                o * scale[..., None]], dim=-1))
    l, o = both[..., :1], both[..., 1:]
    out = torch.where(l > 0, o / l.clamp_min(torch.finfo(l.dtype).tiny), 0.0)
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

def cache_update(k_cache, v_cache, k_new, v_new, pos, *, width=None,
                 first=0):
    """Write one token at ring slot pos % W, per batch element.

    caches: (B, W, Hkv, dh); k_new/v_new: (B, 1, Hkv, dh); pos: (B,).
    ``width``: the caches hold the part of a ring of ``width`` slots that
    starts at slot ``first`` (a rank's part of a ring cut over a mesh
    axis); a stream whose slot lies outside it writes nothing.  The whole
    ring's write (no ``width``) skips that test: it would add a gather
    and a select of each cache a layer to the unsharded token step, whose
    time is the host's launches.
    """
    B, W = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    k_out, v_out = k_cache.clone(), v_cache.clone()
    if width is None:
        slot = pos.long() % W
        k_out[rows, slot] = k_new[:, 0]
        v_out[rows, slot] = v_new[:, 0]
        return k_out, v_out
    local = pos.long() % width - first
    mine = ((local >= 0) & (local < W))[:, None, None]
    slot = local.clamp(0, W - 1)
    k_out[rows, slot] = torch.where(mine, k_new[:, 0], k_cache[rows, slot])
    v_out[rows, slot] = torch.where(mine, v_new[:, 0], v_cache[rows, slot])
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


def cache_positions(pos, W, first=0, n=None):
    """Absolute position stored at each ring slot after writing ``pos``.

    pos: (B,) current (just-written) position.  Slot s holds the largest
    p <= pos with p % W == s; slots never written hold negative values.
    ``first``, ``n``: only the ``n`` slots from ``first`` on (B, n).
    """
    slots = torch.arange(first, first + (W if n is None else n),
                         device=pos.device)
    p = pos.long()[:, None]
    return p - ((p - slots[None, :]) % W)


# ---------------------------------------------------------------------------
# Causal depthwise conv (SSM front-ends)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, bias=None):
    """x: (B, S, C); w: (K, C) depthwise causal conv along S, summed in
    float32 tap by tap (the JAX package's order) and rounded to x's type."""
    K, S = w.shape[0], x.shape[1]
    # one float32 copy of the padded input, whose K shifted views the
    # products share (and autograd saves once)
    pad = F.pad(x, (0, 0, K - 1, 0)).float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i].float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def conv1d_step(x_t, conv_state, w, bias=None):
    """One decode step.  x_t: (B, C); conv_state: (B, K-1, C) past inputs.
    Returns (out (B, C), new state (B, K-1, C))."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x_t.dtype), window[:, 1:, :]
