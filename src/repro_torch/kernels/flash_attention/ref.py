"""Plain PyTorch version of the ring-chunk attention kernel.

The dense masked softmax over [pre-write ring (W slots), chunk keys] with
the kernel's own masks and finalisation: one band test on absolute
positions (``kp >= 0 & kp <= qp & kp > qp - W``, plus the window), softcap
before the mask, the re-mask after ``exp`` and a row with no visible key
written as 0.  The CPU tests run it; on the card ``chip_smoke.py`` holds
the CUDA kernel against it.
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
