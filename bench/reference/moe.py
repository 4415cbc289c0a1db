"""Plain PyTorch forward of a sparse mixture-of-experts decoder
(mixtral-8x22b as the port runs it): the dense backbone of
``reference/dense.py`` with its feed-forward replaced by the experts.

Each token takes the router's top-k logits (the lower expert index first
among equal logits), weights its experts by a softmax over those k logits,
and sums the experts' SwiGLU outputs; no token is dropped.  Every expert
runs over exactly the tokens routed to it, in float32.

Imports torch and the dense reference only.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference import dense


def experts(h, lp: Dict, arch: Dict, p: dense.Prec):
    """The expert feed-forward of one layer over h (S, D), float32."""
    m = lp["moe"]
    E, K = arch["num_local_experts"], arch["num_experts_per_tok"]
    logits = p.mm(h, p.weight(m["router"]))                 # (S, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :K], dim=-1)              # (S, K)
    idx = idx[:, :K]
    D = h.shape[1]
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        u = p.mm(h[tok], p.weight(m["wi"][e].reshape(D, -1)))
        gate, up = u.chunk(2, dim=-1)
        y = p.mm(F.silu(gate) * up, p.weight(m["wo"][e]))
        out.index_add_(0, tok, gates[tok, slot, None] * y)
    return out


def logits(params: Dict, arch: Dict, seqs: Sequence[torch.Tensor],
           rows: Sequence[torch.Tensor], prec: str = "fp32"
           ) -> List[torch.Tensor]:
    """``dense.logits`` with the experts as the feed-forward."""
    if arch["reference"]["activation"] != "swiglu":
        raise ValueError("the MoE reference runs SwiGLU experts")
    return dense.logits(params, arch, seqs, rows, prec, ffn=experts)
