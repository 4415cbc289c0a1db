"""Cross-pod gradient compression with error feedback.

The JAX package's ``compression/grad_compress.py``.  Where the gradient
reduction crosses the slow hop between pods, it is the compression
target:

  int8:  g_q = round(g / s) with a per-row absmax scale s; the residual
         g - dequant(g_q) is carried in an error-feedback buffer and
         added before the next step's quantization — unbiased over time,
         int8 + one float32 scale a row on the wire.
  top-k: keep each row's entries with |g| at least its k-th largest |g|
         (ties at the threshold keep more than k), error feedback for the
         rest.

A transform is ``(grads, ef) -> (compressed grads, ef')``: the
compressed gradients are new tensors in the gradients' types, the
float32 error-feedback buffers are updated in place and returned.  Each
leaf is worked through in pieces along its first axis
(``optim.adamw.piece_rows``; a piece never cuts a row), so the float32
temporaries stay at one piece's size.  On a mesh a row may be cut across
ranks: ``rows`` (a tree shaped like the gradients, of
``launch.sharding.RowGroup`` or None) makes each int8 row's maximum the
full row's (top-k refuses a cut row).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict

import torch

from repro_torch.models.params import tree_map
from repro_torch.optim.adamw import _pieces, piece_rows


def init_compression(params) -> Dict[str, Any]:
    """Error-feedback buffers: float32 zeros shaped like ``params``."""
    return {"ef": tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)}


def _int8_roundtrip(g: torch.Tensor, row=None) -> torch.Tensor:
    amax = g.abs().amax(dim=-1, keepdim=True)
    if row is not None:
        amax = row.amax(amax)
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.round(g / scale).clamp_(-127, 127)
    return q.mul_(scale)


def _topk_roundtrip(g: torch.Tensor, frac: float, row=None) -> torch.Tensor:
    if row is not None:
        raise ValueError("top-k compression of rows that a mesh axis cuts "
                         "is not supported")
    a = g.abs()
    n = a.shape[-1]
    k = max(1, int(n * frac))
    # the k-th largest |g| of each row, as the JAX sort takes it; every
    # entry at or above it stays, so a tie keeps more than k
    thresh = torch.kthvalue(a, n - k + 1, dim=-1, keepdim=True).values
    return torch.where(a >= thresh, g, torch.zeros_like(g))


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k])
    else:
        yield tree


def _make_transform(roundtrip: Callable) -> Callable:
    """(grads, ef, rows=None) -> (compressed grads, ef), ``roundtrip(g,
    row)`` applied to each float32 piece of g + ef."""

    def transform(grads, ef, rows=None):
        row_leaves = (_tree_leaves(rows) if rows is not None
                      else itertools.repeat(None))
        outs = {}
        for g, e, row in zip(_tree_leaves(grads), _tree_leaves(ef),
                             row_leaves):
            out = torch.empty_like(g)
            n = piece_rows(g)
            for gs, es, os_ in zip(_pieces(g, n), _pieces(e, n),
                                   _pieces(out, n)):
                gf = gs.float() + es
                gq = roundtrip(gf, row)
                os_.copy_(gq)
                es.copy_(gf.sub_(gq))
            outs[id(g)] = out
        return tree_map(lambda g: outs[id(g)], grads), ef

    return transform


_int8 = _make_transform(_int8_roundtrip)


def int8_compress_transform(grads, ef, rows=None):
    """(grads, ef) -> (compressed grads, ef'): int8 with per-row absmax
    scales, error feedback in ``ef``."""
    return _int8(grads, ef, rows)


def topk_compress_transform(grads, ef, frac: float = 0.1, rows=None):
    """(grads, ef) -> (compressed grads, ef'): each row's top ``frac`` of
    entries by |g| (at least one), error feedback in ``ef``."""
    return _make_transform(lambda g, row: _topk_roundtrip(g, frac, row))(
        grads, ef, rows)


def compressed_bytes_per_row(n: int) -> float:
    """Wire bytes for one row of n float32 gradients under int8 + scale."""
    return n * 1 + 4


@dataclasses.dataclass
class CompressionState:
    ef: Any

    @classmethod
    def init(cls, params):
        return cls(**init_compression(params))
