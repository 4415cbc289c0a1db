"""AdamW with warmup + cosine schedule, global-norm clipping, f32 moments.

The math of the JAX package's ``optim/adamw.py``: moments are float32
whatever the parameter type, the update is computed in float32 and cast
back (bf16 parameters are their own master copy).  Unlike the JAX
version, ``adamw_update`` updates the parameters and the moments IN PLACE
(under ``torch.no_grad``) and returns the same dicts, and it works through
each leaf in pieces along its first axis — one layer slice of a stacked
leaf at a time — so its float32 temporaries stay at one slice's size: a
straight translation of llama3.2-3b's ``wi`` leaf (28 x 3072 x 2 x 8192)
would make several 5.6 GB temporaries on top of the optimizer state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.kernels import dry
from repro_torch.models.params import from_reference, tree_map

PIECE = 1 << 26          # elements in one piece of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step) -> float:
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def piece_rows(t: torch.Tensor) -> int:
    """How many slices along its first axis one piece of ``t`` takes: at
    most ``PIECE`` elements (at least one slice: a whole layer slice of a
    stacked leaf).  A tensor of one axis or less is one piece, so a piece
    never cuts a row (the last axis)."""
    if t.dim() <= 1 or t.numel() <= PIECE:
        return max(1, t.shape[0]) if t.dim() else 1
    return max(1, PIECE // (t.numel() // t.shape[0]))


def _pieces(t: torch.Tensor, rows: int = 0) -> Tuple[torch.Tensor, ...]:
    """Views of ``t`` along its first axis, ``rows`` slices each
    (``piece_rows(t)`` when 0)."""
    if t.dim() == 0:
        return (t,)
    return torch.split(t, rows or piece_rows(t), dim=0)


def step_count(state) -> int:
    """The step an update makes: the state's ``count`` plus one, read on
    the host.  A fake count (the dry run's, ``kernels/dry.py``) has no
    value to read: the trace takes the first step."""
    count = state["count"]
    return 1 if dry.is_dry(count) else int(count) + 1


def init_opt_state(params) -> Dict[str, Any]:
    """{"m", "v": float32 zeros shaped like params, "count": int32 0}."""
    some = next(_leaves(params))
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=some.device)}


def opt_state_from_reference(opt_np, device="cuda") -> Dict[str, Any]:
    """The JAX package's optimizer state ``{"m", "v", "count"}`` (leaves as
    numpy or JAX arrays) -> the port's, on ``device``."""
    return {k: from_reference(opt_np[k], device) for k in ("m", "v", "count")}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device)."""
    total = None
    for leaf in _leaves(tree):
        for piece in _pieces(leaf):
            sq = piece.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, *, gnorm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step in place.  Returns (params, state, {"grad_norm",
    "lr"}) — the same params and state objects, updated.  ``gnorm``: the
    gradient's global norm when the caller computed it (over every rank's
    shards, ``launch.steps.make_train_step_smap``), else
    ``global_norm(grads)``."""
    count = step_count(state)
    lr = lr_schedule(cfg, count)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** count
    b2c = 1.0 - cfg.b2 ** count
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state["m"]), _leaves(state["v"])):
        for ps, gs, ms, vs in zip(_pieces(p), _pieces(g), _pieces(m),
                                  _pieces(v)):
            gf = gs.float() * scale
            ms.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            vs.mul_(cfg.b2).add_(gf.square_(), alpha=1 - cfg.b2)
            step_dir = (ms / b1c).div_((vs / b2c).sqrt_().add_(cfg.eps))
            pf = ps.float()
            ps.copy_(pf - lr * (step_dir + cfg.weight_decay * pf))
    state["count"].fill_(count)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=gnorm.device)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
