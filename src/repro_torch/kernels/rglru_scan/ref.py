"""Plain PyTorch version of the RG-LRU linear recurrence.

``lru_scan_plain``: ``h_t = a_t h_{t-1} + b_t``, one step at a time in
float32 (the JAX package's oracle ``kernels/rglru_scan/ref.py``), with the
carried state ``h0`` and, like the kernel, a ``reverse`` flag.  The CPU
route of ``ops.lru_scan`` runs it; on the card ``chip_smoke.py`` holds the
CUDA kernel against it.
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
