"""Mixture-of-Experts feed-forward: the counterpart of the JAX package's
``models/moe.py``.

Tokens are routed in blocks of about ``cfg.moe_block`` tokens, cut along
the sequence (never along the batch).  In a block every token claims its
top-K experts; a claim's slot is the count of earlier claims on its
expert in (token, k) order, and a claim is kept iff its slot is below the
capacity C.  Kept claims are scattered into a fixed (B', E, C, D) slot
buffer, the experts run as two batched products over E, and each token
gathers its kept claims' outputs back, weighted by their gates.  Every
shape depends only on (B, S, E, C) and nothing is read on the host, so a
serving step stays capturable in a CUDA graph.

params:
  router: (D, E)
  wi:     (E, D, 2, F) for GLU activations, else (E, D, F)
  wo:     (E, F, D)

Precision follows the JAX einsums: the router logits and the ``wi``
product are float32 from operands in the compute type
(``layers.matmul_f32``, ``layers.bmm_f32``), the activation's output and
the ``wo`` product are rounded to the compute type, a kept claim's gate
is rounded to it, and the sum over a token's claims is float32 before
its rounding.

Top-K takes the lower expert index first among equal logits, as
``lax.top_k`` does (``torch.topk`` does not promise an order among
ties): padded tokens are exactly zero, so their logits tie across all
experts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import bmm_f32, ffn_activation, matmul_f32


def top_k_lowest_first(logits, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    the lower index first among equal values."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(xin, params, activation: str):
    """xin: (B, E, C, D) -> (B, E, C, D), the weights shared over B."""
    B, E, C, D = xin.shape
    wi = params["wi"]
    h = bmm_f32(xin.transpose(0, 1).reshape(E, B * C, D),
                wi.reshape(E, D, -1))                   # (E, B*C, [2]F) f32
    y = torch.bmm(ffn_activation(h, activation, xin.dtype), params["wo"])
    return y.to(xin.dtype).reshape(E, B, C, D).transpose(0, 1)


def moe_block_apply(xblk, params, *, n_experts: int, top_k: int,
                    capacity_factor: float, activation: str,
                    dropless: bool = False):
    """One token block, each row routed alone.  xblk: (B, T, D) -> (B, T,
    D), {"lb_loss", "dropped"}.  ``dropless`` sets the capacity to T, so
    no claim is dropped (the serving steps)."""
    B, T, D = xblk.shape
    E, K = n_experts, top_k
    C = T if dropless else int(max(1, (T * K * capacity_factor) // E))
    C = min(C, T)

    logits = matmul_f32(xblk, params["router"])              # (B, T, E)
    gates_all = torch.softmax(logits, dim=-1)                # (B, T, E)
    top_vals, top_idx = top_k_lowest_first(logits, K)        # (B, T, K)
    top_gates = torch.softmax(top_vals, dim=-1)

    # each claim's slot: the claims before it on its expert, (t, k) order
    expert = top_idx.reshape(B, T * K)
    onehot = (expert[..., None] == torch.arange(E, device=xblk.device)) \
        .long()                                              # (B, TK, E)
    pos = (onehot.cumsum(1) - onehot).gather(-1, expert[..., None])[..., 0]
    keep = pos < C
    # kept claims to their (expert, slot) row of the buffer; dropped ones
    # to a spare row past the end, cut off before the experts run
    row = torch.where(keep, expert * C + pos, E * C)
    src = xblk[:, :, None].expand(B, T, K, D).reshape(B, T * K, D)
    buf = xblk.new_zeros(B, E * C + 1, D).scatter(
        1, row[..., None].expand(B, T * K, D), src)
    y = _expert_ffn(buf[:, :E * C].reshape(B, E, C, D), params, activation)
    got = y.reshape(B, E * C, D).gather(
        1, torch.where(keep, row, 0)[..., None].expand(B, T * K, D))
    gate = (top_gates.reshape(B, T * K) * keep).to(xblk.dtype)
    out = (gate.float()[..., None] * got.float()).reshape(B, T, K, D) \
        .sum(2).to(xblk.dtype)

    # Switch-style load-balance terms
    me = gates_all.mean(dim=(0, 1))                          # (E,)
    ce = onehot.reshape(B, T, K, E).sum(2).float().mean(dim=(0, 1))
    aux = {"lb_loss": E * torch.sum(me * ce),
           "dropped": 1.0 - keep.float().mean()}
    return out, aux


def moe_block_apply_flat(xblk, params, *, n_experts: int, top_k: int,
                         capacity_factor: float, activation: str,
                         dropless: bool = False):
    """The B·T tokens of a block routed jointly, in (b, t) order: xblk
    (B, T, D) -> (B, T, D), aux."""
    B, T, D = xblk.shape
    y, aux = moe_block_apply(
        xblk.reshape(1, B * T, D), params, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, activation=activation,
        dropless=dropless)
    return y.reshape(B, T, D), aux


def moe_apply(x, params, cfg: ModelConfig, *, dropless: bool = False):
    """x: (B, S, D) -> (B, S, D), {"lb_loss", "dropped"} (each the mean over
    blocks).  S is zero-padded to whole blocks of ``blk_s`` positions; a
    block holds every row's positions, routed jointly
    (``cfg.moe_batched=False``) or row by row.  Under autograd each block
    is recomputed in the backward (``torch.utils.checkpoint``), so no
    block's slot buffers are saved."""
    B, S, D = x.shape
    blk_s = max(1, min(max(1, cfg.moe_block // B), S))
    S_pad = -(-S // blk_s) * blk_s
    if S_pad != S:              # padded positions' outputs are discarded
        x = F.pad(x, (0, 0, 0, S_pad - S))
    apply = moe_block_apply if cfg.moe_batched else moe_block_apply_flat

    def block(xb, p):
        y, aux = apply(xb, p, n_experts=cfg.n_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       activation=cfg.activation, dropless=dropless)
        return y, aux["lb_loss"], aux["dropped"]

    ys, lbs, drops = [], [], []
    for s0 in range(0, S_pad, blk_s):
        xb = x[:, s0:s0 + blk_s]
        if torch.is_grad_enabled():
            y, lb, dr = checkpoint(block, xb, params, use_reentrant=False)
        else:
            y, lb, dr = block(xb, params)
        ys.append(y)
        lbs.append(lb)
        drops.append(dr)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, {"lb_loss": torch.stack(lbs).mean(),
               "dropped": torch.stack(drops).mean()}
