"""Plain PyTorch versions of the port's attention kernels.

* ``ring_chunk_attention_ref``: the dense masked softmax over [pre-write
  ring (W slots), chunk keys] with the ring kernel's own masks and
  finalisation: one band test on absolute positions (``kp >= 0 & kp <= qp
  & kp > qp - W``, plus the window), softcap before the mask, the re-mask
  after ``exp`` and a row with no visible key written as 0.
* ``ring_chunk_attention_split_ref``: the same function computed the way
  the bf16 ring kernel computes it — per split of the keys, then a merge
  of the splits — in plain PyTorch, for the tests.
* ``flash_attention_fwd_ref`` / ``flash_attention_bwd_ref``: causal or
  sliding-window GQA self-attention and its gradients, in the math of the
  flash kernels (the JAX package's ``_fwd_kernel``, ``_dq_kernel`` and
  ``_dkv_kernel``), including their casts to the input type: ``p`` before
  the products with ``v`` and ``do``, ``ds`` before the products with
  ``k`` and ``q``.  In float32 those casts do nothing.

The CPU route of each wrapper in ``ops.py`` runs these; on the card
``chip_smoke.py`` holds each CUDA kernel against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
NEVER = -(2 ** 30)      # position of a masked chunk key: no band test passes


def key_positions(pos, n_tokens, W: int, C: int):
    """Absolute positions of the ring slots (B, W) and chunk keys (B, C).

    Ring slot s holds ``last - ((last - s) mod W)`` with ``last = pos - 1``
    (negative = never written); chunk key t' holds ``pos + t'`` while
    ``t' < n_tokens`` and the ``NEVER`` sentinel otherwise."""
    pos = pos.long()[:, None]
    slots = torch.arange(W, device=pos.device)[None, :]
    last = pos - 1
    ring = last - ((last - slots) % W)
    t = torch.arange(C, device=pos.device)[None, :]
    chunk = torch.where(t < n_tokens.long()[:, None], pos + t,
                        torch.full_like(t, NEVER))
    return ring, chunk


def visible(pos, n_tokens, W: int, C: int, window: int = 0):
    """Boolean band mask (B, C, W + C): query row t against [ring, chunk]."""
    ring, chunk = key_positions(pos, n_tokens, W, C)
    kp = torch.cat([ring, chunk], dim=1)[:, None, :]           # (B, 1, W+C)
    qp = (pos.long()[:, None]
          + torch.arange(C, device=pos.device)[None, :])[:, :, None]
    m = (kp >= 0) & (kp <= qp) & (kp > qp - W)
    if window:
        m &= kp > qp - window
    return m


def ring_chunk_attention_ref(q, k_new, v_new, k_cache, v_cache, pos,
                             n_tokens, *, window=0, softcap=0.0):
    """q/k_new/v_new: (B, C, H*, dh); k_cache/v_cache: (B, W, Hkv, dh)
    pre-write ring; pos, n_tokens: (B,).  Returns (B, C, Hq, dh) in
    q.dtype, accumulated in float32."""
    B, C, Hq, dh = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, C, Hkv, G, dh).float()
    k = torch.cat([k_cache, k_new], dim=1).float()             # (B, W+C, ..)
    v = torch.cat([v_cache, v_new], dim=1).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * dh ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = visible(pos, n_tokens, W, C, window)[:, None, None]  # (B,1,1,C,L)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.where(l > 0, l, 1.0), v)
    return out.reshape(B, C, Hq, dh).to(q.dtype)


def ring_chunk_attention_split_ref(q, k_new, v_new, k_cache, v_cache, pos,
                                   n_tokens, *, split_slots, window=0,
                                   softcap=0.0):
    """``ring_chunk_attention_ref`` by the bf16 kernel's split and merge.
    The ring's slots are cut into splits of ``split_slots`` (the last one
    shorter), and the chunk's keys form the last split.  Each split gives
    each query row a normalised partial ``o_s`` and ``lse_s``, the log of
    the sum of exp of its visible scores (``NEG_INF`` where it sees none);
    the row's output is ``sum_s w_s o_s / sum_s w_s`` with ``w_s =
    exp(lse_s - max_s lse_s)``, summed over the splits in order, and 0
    where every split is empty.  Float32 throughout; tests only."""
    B, C, Hq, dh = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, C, Hkv, G, dh).float()
    k = torch.cat([k_cache, k_new], dim=1).float()
    v = torch.cat([v_cache, v_new], dim=1).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * dh ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = visible(pos, n_tokens, W, C, window)[:, None, None]  # (B,1,1,C,L)
    splits = [(a, min(a + split_slots, W)) for a in range(0, W, split_slots)]
    lses, outs = [], []
    for a, e in splits + [(W, W + C)]:
        seen = mask[..., a:e]
        ss = torch.where(seen, s[..., a:e], NEG_INF)
        m = ss.amax(dim=-1, keepdim=True)
        p = torch.where(seen, torch.exp(ss - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        outs.append(torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, a:e])
                    / torch.where(l > 0, l, 1.0))
        lses.append(torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                                NEG_INF))
    lse = torch.stack(lses)                                    # (n,B,H,G,C,1)
    w = torch.where(lse > 0.5 * NEG_INF, torch.exp(lse - lse.amax(dim=0)),
                    0.0)
    den = w.sum(dim=0)
    out = (w * torch.stack(outs)).sum(dim=0) / torch.where(den > 0, den, 1.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence flash attention (training forward and backward)
# ---------------------------------------------------------------------------

def attention_mask(Sq: int, Skv: int, causal: bool, window: int, device):
    """(Sq, Skv) boolean: query position t sees key position j iff
    ``j <= t`` (causal) and ``j > t - window`` (window > 0) — the mask of
    the JAX kernels, whose query and key positions both start at 0."""
    t = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Skv, device=device)[None, :]
    m = torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    if causal:
        m &= j <= t
    if window:
        m &= j > t - window
    return m


def _grouped_scores(q, k, causal, window):
    """Scaled, masked scores (B, Hkv, G, Sq, Skv) in float32 and the mask."""
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * dh ** -0.5
    mask = attention_mask(Sq, k.shape[1], causal, window, q.device)
    return s, mask


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=0):
    """q: (B, Sq, Hq, dh); k/v: (B, Skv, Hkv, dh), query head h reading kv
    head ``h // (Hq // Hkv)``.  Returns (out (B, Sq, Hq, dh) in q.dtype,
    lse (B, Hq, Sq) float32 of the scaled scores).  A row with no visible
    key comes out 0 with lse ``-1e30``."""
    B, Sq, Hq, dh = q.shape
    s, mask = _grouped_scores(q, k, causal, window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]         # (B,Hkv,G,Sq)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l > 0, l, 1.0).permute(0, 3, 1, 2, 4)
    return (o.reshape(B, Sq, Hq, dh).to(q.dtype),
            lse.reshape(B, Hq, Sq))


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal=True, window=0):
    """Gradients of ``flash_attention_fwd_ref``'s ``out`` for the upstream
    gradient ``do`` (q's shape), from the saved ``out`` and ``lse``
    (B, Hq, Sq).  Recomputes ``p = exp(s - lse)`` under the mask, takes
    ``delta = rowsum(out * do)`` and ``ds = p * (dp - delta) * scale``;
    dk and dv sum over the G query heads of each kv head.  Returns
    (dq, dk, dv) in the types of q, k and v."""
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = dh ** -0.5
    s, mask = _grouped_scores(q, k, causal, window)
    lse_g = lse.reshape(B, Hkv, G, Sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dog = do.reshape(B, Sq, Hkv, G, dh).float()
    delta = (out.float() * do.float()).sum(-1)                 # (B, Sq, Hq)
    delta = delta.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(),
                      q.reshape(B, Sq, Hkv, G, dh).float())
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    return (dq.reshape(B, Sq, Hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
