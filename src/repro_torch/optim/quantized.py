"""8-bit AdamW: block-quantized moments (int8 + per-row float32 scales).

The JAX package's ``optim/quantized.py``: ``m`` is stored as signed int8
with absmax row scales and ``sqrt(v)`` as unsigned int8 with max row
scales (sqrt-space halves the dynamic range the 8 bits must cover, so
small second moments do not collapse to 0).  A row is the last axis; each
has one float32 scale, shape ``(..., 1)``.  Rounding is to nearest with
ties to even (``torch.round`` as ``jnp.round``), clipped to ±127 and
0..255, with scales floored at 1e-12.  The moments take a quarter of the
float32 ones' bytes: with bf16 weights and gradients a parameter holds 6
bytes of training state instead of 12.

As in ``optim/adamw.py`` the update runs in place under ``no_grad``, leaf
by leaf, in pieces along the first axis (``piece_rows``), so the float32
temporaries of the dequantize -> update -> requantize round trip stay at
one piece's size; a piece never cuts a row.

On a mesh a row may be split across ranks (its last axis sharded):
``rows`` then gives, leaf for leaf, the reduction that turns a piece's
row maxima into the whole rows' (``launch.sharding.RowGroup``), and
``gnorm`` the global gradient norm over every rank's shards.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.params import from_reference, tree_map
from repro_torch.optim.adamw import (AdamWConfig, _leaves, _pieces,
                                     global_norm, lr_schedule, piece_rows,
                                     step_count)


def _row_max(x: torch.Tensor, row) -> torch.Tensor:
    m = x.amax(dim=-1, keepdim=True)
    return m if row is None else row.amax(m)


def _quant_signed(x: torch.Tensor, row=None):
    scale = (_row_max(x.abs(), row) / 127.0).clamp_min(1e-12)
    q = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.float()


def _dequant_signed(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _quant_unsigned(x: torch.Tensor, row=None):
    scale = (_row_max(x, row) / 255.0).clamp_min(1e-12)
    q = torch.round(x / scale).clamp_(0, 255).to(torch.uint8)
    return q, scale.float()


def _dequant_unsigned(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_opt_state_8bit(params) -> Dict[str, Any]:
    """{"m": {"q": int8, "scale"}, "v": {"q": uint8, "scale"} for every
    leaf (float32 scales of shape ``leaf.shape[:-1] + (1,)``), "count":
    int32 0}, all zeros, on the leaves' devices."""
    def zq(dtype):
        return lambda p: {
            "q": torch.zeros(p.shape, dtype=dtype, device=p.device),
            "scale": torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                                 device=p.device)}

    some = next(_leaves(params))
    return {"m": tree_map(zq(torch.int8), params),
            "v": tree_map(zq(torch.uint8), params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device)}


def opt_state_8bit_from_reference(opt_np, device="cuda") -> Dict[str, Any]:
    """The JAX package's 8-bit state ``{"m", "v": {"q", "scale"} leaves,
    "count"}`` (numpy or JAX arrays) -> the port's, on ``device``."""
    return {k: from_reference(opt_np[k], device) for k in ("m", "v", "count")}


def _qleaves(tree):
    """The {"q", "scale"} dicts of a moment tree, in ``_leaves`` order."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _qleaves(tree[k])


@torch.no_grad()
def adamw8bit_update(grads, state, params, cfg: AdamWConfig, *, gnorm=None,
                     rows=None
                     ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One 8-bit AdamW step in place: (params, state, {"grad_norm", "lr"}),
    the same objects updated.  ``gnorm``: the global gradient norm when the
    caller computed it; ``rows``: a tree shaped like ``params`` whose
    leaves reduce a row maximum across the ranks that share the row (None
    where no mesh axis cuts it), or None."""
    count = step_count(state)
    lr = lr_schedule(cfg, count)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** count
    b2c = 1.0 - cfg.b2 ** count
    row_leaves = _leaves(rows) if rows is not None else itertools.repeat(None)
    for p, g, mq, vq, row in zip(_leaves(params), _leaves(grads),
                                 _qleaves(state["m"]), _qleaves(state["v"]),
                                 row_leaves):
        n = piece_rows(p)
        for ps, gs, mqs, mss, vqs, vss in zip(
                _pieces(p, n), _pieces(g, n), _pieces(mq["q"], n),
                _pieces(mq["scale"], n), _pieces(vq["q"], n),
                _pieces(vq["scale"], n)):
            gf = gs.float() * scale
            # the JAX expression's float32 operations one at a time:
            # b1 * m + (1 - b1) * g, b2 * sqrt(v)^2 + (1 - b2) * g^2
            m = _dequant_signed(mqs, mss).mul_(cfg.b1).add_(gf * (1 - cfg.b1))
            v = _dequant_unsigned(vqs, vss).square_().mul_(cfg.b2)
            v.add_(gf.square_().mul_(1 - cfg.b2))
            del gf
            step_dir = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            pf = ps.float()
            ps.copy_(pf - lr * (step_dir + cfg.weight_decay * pf))
            del step_dir, pf
            q, s = _quant_signed(m, row)
            mqs.copy_(q)
            mss.copy_(s)
            q, s = _quant_unsigned(v.sqrt_(), row)
            vqs.copy_(q)
            vss.copy_(s)
    state["count"].fill_(count)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=gnorm.device)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
