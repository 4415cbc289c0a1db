"""Plain PyTorch versions of the SSD chunked scan.

* ``ssd_scan_plain``: the function of the kernel (``ops.ssd_scan``, the
  contract of the JAX package's ``kernels/ssd_scan/kernel.py:72``) in
  the kernel's head-major layout — per (head, chunk) the intra-chunk
  ``(C Bᵀ ∘ causal decay) @ xdt``, the inter-chunk ``exp(acum) C @ state``
  and the state update, the state carried across chunks.  The CPU route
  of ``ops.ssd_scan`` runs it; on the card ``chip_smoke.py`` holds the
  CUDA kernel against it.
* ``ssd_scan_ref``: the per-step oracle in the model layout (the JAX
  package's ``kernels/ssd_scan/ref.py``): ``h_t = exp(dt_t A) h_{t-1} +
  dt_t B_t x_tᵀ``, ``y_t = C_t · h_t``.
"""
from __future__ import annotations

import torch


def ssd_scan_plain(xdt, a, B_, C_, *, chunk=128, hq_per_group=1):
    """xdt: (BH, S, P) dt-weighted inputs; a: (BH, S) log-decays; B_/C_:
    (BG, S, N) with BH = BG * hq_per_group (head b reads group b //
    hq_per_group).  Returns (y (BH, S, P) float32, h_final (BH, N, P)
    float32)."""
    BH, S, P = xdt.shape
    N = B_.shape[2]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    Bf = B_.float().repeat_interleave(hq_per_group, dim=0)
    Cf = C_.float().repeat_interleave(hq_per_group, dim=0)
    x = xdt.float().reshape(BH, nc, Q, P)
    Bc, Cc = Bf.reshape(BH, nc, Q, N), Cf.reshape(BH, nc, Q, N)
    a_cum = a.float().reshape(BH, nc, Q).cumsum(-1)            # inclusive
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (a_cum[..., :, None] - a_cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))                     # masked before exp
    scores = Cc @ Bc.transpose(-1, -2)                          # (BH,nc,Q,Q)
    y = (scores * torch.exp(seg)) @ x                           # intra
    decay_end = torch.exp(a_cum[..., -1:] - a_cum)              # (BH,nc,Q)
    s_c = Bc.transpose(-1, -2) @ (decay_end[..., None] * x)     # (BH,nc,N,P)
    h = torch.zeros(BH, N, P, dtype=torch.float32, device=x.device)
    for c in range(nc):
        y[:, c] += torch.exp(a_cum[:, c])[..., None] * (Cc[:, c] @ h)
        h = torch.exp(a_cum[:, c, -1])[:, None, None] * h + s_c[:, c]
    return y.reshape(BH, S, P), h


def ssd_scan_ref(x, dt, A, B_, C_, h0=None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B_/C_: (B, S, G, N); h0:
    (B, H, P, N) or None.  Returns (y (B, S, H, P), h_final (B, H, P, N)),
    float32, one step at a time."""
    Bb, S, H, P = x.shape
    rep = H // B_.shape[2]
    Bf = B_.float().repeat_interleave(rep, dim=2)
    Cf = C_.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros(Bb, H, P, Bf.shape[3], dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None])                 # (B, H)
        h = h * decay[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bf[:, t], xf[:, t], dtf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1), h
