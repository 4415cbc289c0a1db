"""Plain PyTorch forward of a dense decoder (starcoder2-15b as the port
runs it): float32 from the bf16 weights, no kernel, no cache, no
batching, layer by layer so that it fits beside the weights.

Architecture (each departure from the published model is listed in the
configuration file's ``assumed``): token embedding; per layer a pre-norm
(RMSNorm with a scale) grouped-query attention with half-split rotary
embeddings on q and k, causal (and windowed where the model has a window),
query head h reading key/value head h // (Hq / Hkv), output projection,
residual; a pre-norm feed-forward (GeLU with the tanh approximation, no
gate; or SwiGLU: gate and up halves of ``wi``), residual; a final RMSNorm
and the output head over the published vocabulary.

``prec="fp8"`` is the control: every projection's operands rounded to
float8 e4m3 (weights an output column, activations a row, each scaled to
the format's range) before a float32 product, the nearest precision below
the configuration's bf16.  ``prec="bf16"`` rounds each projection's
activations to bf16 (the weights are bf16 already): a witness of what the
configuration's own precision gives.

Imports torch only: nothing of the program and nothing of JAX.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                 # largest finite float8 e4m3fn value
Q_BLOCK = 512                   # query rows of one attention block


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale along ``dim`` (the
    reduction axis of the product it feeds), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Prec:
    """The product of an activation (M, K) and a weight (K, N), float32,
    with both rounded to float8 first in the control."""

    def __init__(self, prec: str):
        if prec not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {prec!r}")
        self.fp8 = prec == "fp8"
        self.bf16 = prec == "bf16"
        self.cache: Dict = {}       # one layer's weights, as read

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A layer's weight as the products read it: float32, or rounded
        per output column (dim -2 is the contraction); made once a layer
        (``cache`` is cleared between layers)."""
        key = (w.data_ptr(), tuple(w.shape))
        if key not in self.cache:
            f = w.float()
            self.cache[key] = fp8(f, -2) if self.fp8 else f
        return self.cache[key]

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = fp8(x, -1)
        elif self.bf16:
            x = x.to(torch.bfloat16).float()
        return x @ w


def rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, theta: float):
    """x (S, H, dh) at positions 0..S-1: half-split rotation."""
    S, _, dh = x.shape
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, window: int):
    """Causal grouped-query attention, float32: q (S, Hq, dh), k/v (S,
    Hkv, dh) -> (S, Hq * dh), Q_BLOCK query rows at a time."""
    S, Hq, dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    kt = k.permute(1, 2, 0)                                 # (Hkv, dh, S)
    vt = v.permute(1, 0, 2)                                 # (Hkv, S, dh)
    keys = torch.arange(S, device=q.device)
    out = []
    for r0 in range(0, S, Q_BLOCK):
        qb = q[r0:r0 + Q_BLOCK]
        n = qb.shape[0]
        qg = qb.reshape(n, Hkv, G, dh).permute(1, 2, 0, 3)  # (Hkv, G, n, dh)
        s = torch.matmul(qg, kt[:, None]) * dh ** -0.5      # (Hkv, G, n, S)
        rows = keys[r0:r0 + n, None]
        vis = keys[None, :] <= rows
        if window:
            vis &= keys[None, :] > rows - window
        s = s.masked_fill(~vis, float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), vt[:, None])
        out.append(o.permute(2, 0, 1, 3).reshape(n, Hq * dh))
    return torch.cat(out)


def mlp(h, lp: Dict, arch: Dict, p: Prec):
    """The dense feed-forward of one layer."""
    act = arch["reference"]["activation"]
    wi = lp["mlp"]["wi"]
    D = wi.shape[0]
    u = p.mm(h, p.weight(wi.reshape(D, -1)))
    if act == "swiglu":
        gate, up = u.chunk(2, dim=-1)
        a = F.silu(gate) * up
    elif act == "gelu_tanh":
        a = F.gelu(u, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return p.mm(a, p.weight(lp["mlp"]["wo"]))


def layer(x, lp: Dict, arch: Dict, p: Prec, ffn: Callable):
    """One decoder layer over one sequence x (S, D), float32."""
    eps = arch["reference"]["norm_eps"]
    S, D = x.shape
    a = lp["attn"]
    h = rms(x, lp["ln1"], eps)
    q = p.mm(h, p.weight(a["wq"].reshape(D, -1))).reshape(
        S, a["wq"].shape[1], -1)
    k = p.mm(h, p.weight(a["wk"].reshape(D, -1))).reshape(
        S, a["wk"].shape[1], -1)
    v = p.mm(h, p.weight(a["wv"].reshape(D, -1))).reshape(
        S, a["wv"].shape[1], -1)
    theta = float(arch["rope_theta"])
    o = attention(rope(q, theta), rope(k, theta), v,
                  arch["reference"].get("window", 0))
    x = x + p.mm(o, p.weight(a["wo"].reshape(-1, D)))
    return x + ffn(rms(x, lp["ln2"], eps), lp, arch, p)


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked tree."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


def logits(params: Dict, arch: Dict, seqs: Sequence[torch.Tensor],
           rows: Sequence[torch.Tensor], prec: str = "fp32",
           ffn: Callable = mlp) -> List[torch.Tensor]:
    """Float32 logits over the published vocabulary at positions
    ``rows[i]`` of each token sequence ``seqs[i]`` (1-D, on the weights'
    device): the whole model, every sequence through a layer before the
    next layer."""
    p = Prec(prec)
    eps = arch["reference"]["norm_eps"]
    with torch.no_grad():
        xs = [params["embed"][s.long()].float() for s in seqs]
        for i in range(arch["num_hidden_layers"]):
            lp = layer_params(params, i)
            p.cache.clear()
            xs = [layer(x, lp, arch, p, ffn) for x in xs]
        p.cache.clear()
        head = p.weight(params["head"][:, :arch["vocab_size"]])
        return [p.mm(rms(x[r.long()], params["final_norm"], eps), head)
                for x, r in zip(xs, rows)]
