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

Recomputation.  Where autograd records the layer
(``layers.records_grad``) with ``cfg.remat == "none"``, each token
block is recomputed in its backward (``torch.utils.checkpoint``), so no
block's slot buffers are saved.  With remat on, the layer's own
checkpoint (``transformer._run``) recomputes the whole MoE forward in the
backward, and the blocks take no checkpoint of their own.  Nested, they
would hold a layer's gathered expert weights from its forward to its
backward: a non-reentrant checkpoint keeps its inputs until its
backward, and the inner checkpoints of the layer's first forward are the
ones that recompute their blocks then, so under FSDP every layer's
gathered ``wi`` / ``wo`` stayed alive at once.  Of the two repairs, this
one costs memory in one place: a layer's backward holds the saved
tensors of all its blocks at once, where JAX's nested ``jax.checkpoint``
holds one block's.  The other, gathering ``wi`` / ``wo`` inside each
block so that its checkpoint keeps the rank's shards, would repeat the
layer's FSDP gathers once a block in the forward, again in the
recompute and again in each block's backward.

Tensor parallelism (``tp``, ``models/tensor_parallel.py``, the train
step of ``launch.steps.make_train_step_spmd``).  The specs keep
``expert`` whole and cut ``ff`` over the model axis, so each rank runs
the batched expert products on its ``ff`` slice of ``wi`` / ``wo`` and
the combine sums the ranks' partial outputs (float32, before the
rounding).  Routing (router, top-K, capacity, slots) is computed the same
on every rank of the axis from the whole hidden states; the gates'
gradient is summed over it, since each rank's combine sees its partial
outputs.  The batch is cut over the batch axes: the block length comes
from the global batch's rows, as GSPMD's, and the load-balance means and
``dropped`` are the global batch's (``tp.batch_mean``).  Where a block
routes its rows jointly (``moe_block_apply_flat``) it routes the global
batch's rows, as GSPMD's: the capacity is the global block's, and a
claim's slot counts the claims on its expert of the lower batch shards'
rows too (their per-expert counts, gathered over the batch axes), so a
rank keeps exactly the claims that the global routing keeps.  Its slot
buffer holds only its own kept claims: at most ``min(C, T)`` an expert
for its T tokens, since a token claims an expert once.  The serving
steps' ``tp`` (``means=False``) leaves the balance terms the rank's own,
and a dropless block keeps every claim without the other shards' counts:
they add no collective whose result they discard.

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
from repro_torch.models.layers import (bmm_f32, ffn_activation, matmul_f32,
                                      records_grad)


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
                    dropless: bool = False, tp=None, joint: bool = False):
    """One token block, each row routed alone.  xblk: (B, T, D) -> (B, T,
    D), {"lb_loss", "dropped"}.  ``dropless`` sets the capacity to T, so
    no claim is dropped (the serving steps; a rank's claims then need no
    count of the other batch shards').  ``tp``: see the module note;
    ``joint`` (B = 1): the T tokens are this rank's share of a block that
    the global batch's rows route jointly."""
    B, T, D = xblk.shape
    split = tp is not None and tp.splits("ff")
    shards = tp.batch_shards if tp is not None and joint else 1
    E, K = n_experts, top_k
    Tg = T * shards                    # the tokens routed jointly
    C = Tg if dropless else int(max(1, (Tg * K * capacity_factor) // E))
    C = min(C, Tg)
    Cb = min(C, T)                     # a rank's kept claims an expert

    logits = matmul_f32(xblk, params["router"])              # (B, T, E)
    gates_all = torch.softmax(logits, dim=-1)                # (B, T, E)
    top_vals, top_idx = top_k_lowest_first(logits, K)        # (B, T, K)
    top_gates = torch.softmax(top_vals, dim=-1)

    # each claim's slot: the claims before it on its expert, (t, k) order
    expert = top_idx.reshape(B, T * K)
    onehot = (expert[..., None] == torch.arange(E, device=xblk.device)) \
        .long()                                              # (B, TK, E)
    pos = (onehot.cumsum(1) - onehot).gather(-1, expert[..., None])[..., 0]
    glob = pos
    if shards > 1 and not dropless:   # after the lower shards' claims
        every = tp.comm.all_gather(onehot.sum(1), tp.batch_axes, 0)  # (n, E)
        before = every[:tp.comm.index(tp.batch_axes)].sum(0)
        glob = pos + before.gather(0, expert.reshape(-1)).reshape(B, T * K)
    keep = glob < C
    # kept claims to their (expert, slot) row of the buffer; dropped ones
    # to a spare row past the end, cut off before the experts run
    row = torch.where(keep, expert * Cb + pos, E * Cb)
    xe = tp.copy(xblk) if split else xblk
    src = xe[:, :, None].expand(B, T, K, D).reshape(B, T * K, D)
    buf = xblk.new_zeros(B, E * Cb + 1, D).scatter(
        1, row[..., None].expand(B, T * K, D), src)
    y = _expert_ffn(buf[:, :E * Cb].reshape(B, E, Cb, D), params, activation)
    got = y.reshape(B, E * Cb, D).gather(
        1, torch.where(keep, row, 0)[..., None].expand(B, T * K, D))
    gate = (top_gates.reshape(B, T * K) * keep).to(xblk.dtype)
    if split:                   # the ranks' partial outputs meet the gates
        gate = tp.copy(gate)
    out = (gate.float()[..., None] * got.float()).reshape(B, T, K, D).sum(2)
    if split:
        out = tp.reduce(out)
    out = out.to(xblk.dtype)

    # Switch-style load-balance terms
    me = gates_all.mean(dim=(0, 1))                          # (E,)
    ce = onehot.reshape(B, T, K, E).sum(2).float().mean(dim=(0, 1))
    dropped = 1.0 - keep.float().mean()
    if tp is not None:          # the global batch's means
        me, ce, dropped = (tp.batch_mean(t) for t in (me, ce, dropped))
    aux = {"lb_loss": E * torch.sum(me * ce), "dropped": dropped}
    return out, aux


def moe_block_apply_flat(xblk, params, *, n_experts: int, top_k: int,
                         capacity_factor: float, activation: str,
                         dropless: bool = False, tp=None):
    """The B·T tokens of a block routed jointly, in (b, t) order: xblk
    (B, T, D) -> (B, T, D), aux."""
    B, T, D = xblk.shape
    y, aux = moe_block_apply(
        xblk.reshape(1, B * T, D), params, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, activation=activation,
        dropless=dropless, tp=tp, joint=True)
    return y.reshape(B, T, D), aux


def moe_apply(x, params, cfg: ModelConfig, *, dropless: bool = False,
              tp=None):
    """x: (B, S, D) -> (B, S, D), {"lb_loss", "dropped"} (each the mean over
    blocks).  S is zero-padded to whole blocks of ``blk_s`` positions; a
    block holds every row's positions, routed jointly
    (``cfg.moe_batched=False``) or row by row.  Under autograd each block
    is recomputed in its backward unless the layer is (see the module
    note on recomputation)."""
    B, S, D = x.shape
    # the block's positions from the global batch's rows (GSPMD's B)
    rows = B * (tp.batch_shards if tp is not None else 1)
    blk_s = max(1, min(max(1, cfg.moe_block // rows), S))
    S_pad = -(-S // blk_s) * blk_s
    if S_pad != S:              # padded positions' outputs are discarded
        x = F.pad(x, (0, 0, 0, S_pad - S))
    apply = moe_block_apply if cfg.moe_batched else moe_block_apply_flat

    def block(xb, p):
        y, aux = apply(xb, p, n_experts=cfg.n_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       activation=cfg.activation, dropless=dropless, tp=tp)
        return y, aux["lb_loss"], aux["dropped"]

    recompute = cfg.remat == "none" and records_grad(x, params)
    ys, lbs, drops = [], [], []
    for s0 in range(0, S_pad, blk_s):
        xb = x[:, s0:s0 + blk_s]
        if recompute:
            y, lb, dr = checkpoint(block, xb, params, use_reentrant=False)
        else:
            y, lb, dr = block(xb, params)
        ys.append(y)
        lbs.append(lb)
        drops.append(dr)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, {"lb_loss": torch.stack(lbs).mean(),
               "dropped": torch.stack(drops).mean()}
