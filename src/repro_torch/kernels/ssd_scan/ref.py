"""Plain PyTorch versions of the SSD chunked scan.

* ``ssd_scan_plain``: the function of the kernel (``ops.ssd_scan``, the
  contract of the JAX package's ``kernels/ssd_scan/kernel.py:72``) in
  the kernel's head-major layout — per (head, chunk) the intra-chunk
  ``(C Bᵀ ∘ causal decay) @ xdt``, the inter-chunk ``exp(acum) C @ state``
  and the state update, the state carried across chunks.  The CPU route
  of ``ops.ssd_scan`` runs it; on the card ``chip_smoke.py`` holds the
  CUDA kernel against it.
* ``ssd_scan_split_ref``: the same function in the arithmetic of the
  bf16 tensor-core kernel (``csrc/ssd_scan_wgmma.cu``): B and C exact
  bf16, every float32 operand split in two bf16 parts, float32 sums.
  Tests hold it against the JAX kernel and the plain version; the kernel
  itself runs only on a card.
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


def _parts(t):
    """A float32 tensor as its two bf16 parts, widened back to float32:
    hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def ssd_scan_split_ref(xdt, a, B_, C_, *, chunk=128, hq_per_group=1):
    """``ssd_scan_plain``'s function as the bf16 kernel computes it: C Bᵀ
    from bf16 B and C (exact products, float32 sums); the decay-weighted
    scores, xdt, the decay-weighted xdt of the state update and the
    carried state each split in bf16 hi and lo parts; a product of a
    float32 operand and a bf16 one takes hi·b + lo·b, one of two float32
    operands hi·hi + hi·lo + lo·hi (lo·lo dropped).  Same arguments and
    results as ``ssd_scan_plain``; B_/C_ are taken as bf16."""
    BH, S, P = xdt.shape
    N = B_.shape[2]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q

    def bf16(m):
        return m.to(torch.bfloat16).float().repeat_interleave(
            hq_per_group, dim=0).reshape(BH, nc, Q, N)

    Bc, Cc = bf16(B_), bf16(C_)
    x = xdt.float().reshape(BH, nc, Q, P)
    a_cum = a.float().reshape(BH, nc, Q).cumsum(-1)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (a_cum[..., :, None] - a_cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    w_hi, w_lo = _parts((Cc @ Bc.transpose(-1, -2)) * torch.exp(seg))
    x_hi, x_lo = _parts(x)
    y = w_hi @ x_hi + w_hi @ x_lo + w_lo @ x_hi
    decay_end = torch.exp(a_cum[..., -1:] - a_cum)
    xd_hi, xd_lo = _parts(decay_end[..., None] * x)
    Bt = Bc.transpose(-1, -2)
    s_c = Bt @ xd_hi + Bt @ xd_lo                               # (BH,nc,N,P)
    h = torch.zeros(BH, N, P, dtype=torch.float32, device=x.device)
    for c in range(nc):
        h_hi, h_lo = _parts(h)
        y[:, c] += torch.exp(a_cum[:, c])[..., None] * (
            Cc[:, c] @ h_hi + Cc[:, c] @ h_lo)
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
