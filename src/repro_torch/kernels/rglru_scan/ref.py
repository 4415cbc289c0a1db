"""Plain PyTorch versions of the RG-LRU linear recurrence.

* ``lru_scan_plain``: ``h_t = a_t h_{t-1} + b_t``, one step at a time in
  float32 (the JAX package's oracle ``kernels/rglru_scan/ref.py``), with
  the carried state ``h0`` and, like the kernel, a ``reverse`` flag.  The
  CPU route of ``ops.lru_scan`` runs it; on the card ``chip_smoke.py``
  holds the CUDA kernel against it.
* ``lru_vjp_plain``: the custom VJP's (da, db), one step at a time: the
  CPU route of ``ops._lru_vjp``.
* ``lru_scan_single_pass_ref``: the kernel's arithmetic — chunk-local
  aggregates, the carry folded from ``h0`` in chunk order, the re-run from
  it — for the CPU tests.  Nothing on the main path calls it.
"""
from __future__ import annotations

import torch


def lru_scan_plain(a, b, h0=None, reverse=False):
    """a, b: (B, S, W); h0: (B, W) or None (zeros).  Returns (h (B, S, W),
    h_final (B, W)), float32.  ``reverse`` scans from the end: h_t = a_t
    h_{t+1} + b_t with h_S = h0, and h_final is h_0."""
    B, S, W = a.shape
    af, bf = a.float(), b.float()
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out, h


def lru_vjp_plain(a, g, h):
    """(da, db) of h = lru(a, b) (from a zero state) for the cotangent g:
    db_t = g_t + a_{t+1} db_{t+1} (db_{S-1} = g_{S-1}) and da_t = db_t
    h_{t-1} (h_{-1} = 0), one step at a time in float32."""
    B, S, W = a.shape
    af, gf, hf = a.float(), g.float(), h.float()
    da = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    acc = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for t in range(S - 1, -1, -1):
        acc = (af[:, t + 1] * acc if t + 1 < S else 0.0) + gf[:, t]
        db[:, t] = acc
        da[:, t] = acc * hf[:, t - 1] if t > 0 else 0.0
    return da, db


def _fma(x, y, z):
    """x * y + z rounded once to float32, as the kernel's fma: the float32
    product is exact in float64."""
    return (x.double() * y.double() + z.double()).float()


def lru_scan_single_pass_ref(a, b, h0=None, reverse=False, T=32):
    """The kernel's arithmetic for chunks of T steps (``csrc/lru_scan.cu``):
    each chunk's aggregate P = prod a, E = its end state from zero; the
    carry into chunk c folded from h0 in chunk order, carry_{k+1} =
    fma(P_k, carry_k, E_k); the chunk re-run from its carry, h = fma(a, h,
    b).  Same arguments and results as ``lru_scan_plain``."""
    B, S, W = a.shape
    af, bf = a.float(), b.float()
    if reverse:
        af, bf = af.flip(1), bf.flip(1)
    carry = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
             if h0 is None else h0.float())
    if S == 0:
        return torch.empty((B, 0, W), dtype=torch.float32,
                           device=a.device), carry.clone()
    nc = -(-S // T)
    # pad the last chunk with identity steps (a 1, b 0): P and E unchanged
    pad = nc * T - S
    ac = torch.cat([af, af.new_ones((B, pad, W))], 1).view(B, nc, T, W)
    bc = torch.cat([bf, bf.new_zeros((B, pad, W))], 1).view(B, nc, T, W)
    P = torch.ones((B, nc, W), dtype=torch.float32, device=a.device)
    E = torch.zeros_like(P)
    for j in range(T):
        E = _fma(ac[:, :, j], E, bc[:, :, j])
        P = P * ac[:, :, j]
    carries = torch.empty_like(P)
    for k in range(nc):
        carries[:, k] = carry
        carry = _fma(P[:, k], carry, E[:, k])
    h = carries
    out = torch.empty((B, nc, T, W), dtype=torch.float32, device=a.device)
    for j in range(T):
        h = _fma(ac[:, :, j], h, bc[:, :, j])
        out[:, :, j] = h
    out = out.view(B, nc * T, W)[:, :S]
    h_final = out[:, -1].clone()
    return (out.flip(1) if reverse else out.contiguous()), h_final
