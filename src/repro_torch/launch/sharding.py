"""Sharding rules: logical parameter axes -> mesh PartitionSpecs, and how
the port realizes a spec on a rank.

The spec functions are the JAX package's ``launch/sharding.py``, spec for
spec (the "megatron" discipline):
  vocab/heads/kv_heads/ff/lru/ssd_* -> "model"   (when divisible)
  embed (d_model)                   -> None, or "data"-sharded under FSDP
  expert                            -> None
  batch dims                        -> ("pod","data")
FSDP turns on when the training state per chip would exceed the budget
(``needs_fsdp``); ``opt_specs`` adds "data" to the moments (ZeRO-1).
``PartitionSpec`` is a tuple of mesh-axis entries (None, an axis name or
a tuple of names), ``NamedSharding`` a mesh and a spec.

**Sharded at rest, gathered on use.**  A rank holds, of each leaf, the
slice its spec gives it: a dim sharded over axes ``(a, b)`` is cut into
``|a|·|b|`` equal parts in mixed-radix order (``local_slices``; a dim that
does not divide raises).  ``gather`` puts a leaf back together from the
ranks that hold its parts; ``gather_on_use`` does so inside the
differentiated region, and its backward sums the gradient over the batch
axes (the ranks that saw other rows) and keeps this rank's slice.  Where
a leaf is gathered along ``model`` (every leaf in the smap step; in
``launch.steps.make_train_step_spmd`` and the spmd serving steps, which
split every layer type, only an SSD layer's whose heads the axis does
not divide) every rank of
the axis repeats the compute, so the numerics equal GSPMD's up to the
order of reductions.  ``RowGroup`` reduces a row maximum across the ranks a
sharded last axis spreads it over: the 8-bit moments' and the int8
compression's per-row scales.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import (logical_axes, model_def,
                                       n_params, param_bytes, tree_map)


HBM_PER_CHIP = 16e9
TRAIN_BYTES_PER_PARAM = 12.0   # bf16 p + bf16 g + f32 m + f32 v
BATCH_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """A mesh-axis entry per tensor dim (dims past its length are
    replicated): None, an axis name, or a tuple of axis names (a tuple of
    one name is that name, as in JAX)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# spec functions (the JAX package's, spec for spec)
# ---------------------------------------------------------------------------

def needs_fsdp(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
               model_size: int) -> bool:
    if shape.kind != "train":
        # serving: params only; spread over model axis must fit
        return (param_bytes(cfg) / model_size) > 0.6 * HBM_PER_CHIP
    per_chip = n_params(cfg) * TRAIN_BYTES_PER_PARAM / n_chips
    return per_chip > 0.35 * HBM_PER_CHIP


def axis_rules(cfg: ModelConfig, mesh, *, fsdp: bool
               ) -> Dict[Optional[str], Optional[str]]:
    msize = mesh.shape["model"]

    def fits(dim: int) -> Optional[str]:
        return "model" if dim % msize == 0 and dim >= msize else None

    def fits_heads(hq: int) -> Optional[str]:
        # padded query groups (head_pad_to) leave the PARAM at hq heads:
        # replicated unless hq itself divides
        return "model" if hq and hq % msize == 0 else None

    return {
        "vocab": "model",                       # GSPMD pads uneven vocab
        "embed": "data" if fsdp else None,
        "heads": fits_heads(cfg.n_heads or 0),
        "kv_heads": fits(cfg.n_kv_heads or 0),
        "ff": fits(cfg.d_ff or 0),
        "expert": None,
        "lru": fits(cfg.lru_width or 0),
        "ssd_inner": fits(cfg.d_inner if cfg.ssm_state else 0),
        "ssd_bc": fits(cfg.ssm_groups * cfg.ssm_state if cfg.ssm_state else 0),
        "ssd_heads": fits(cfg.ssm_heads if cfg.ssm_state else 0),
        "layer": None,
        None: None,
    }


def spec_of(ax_tuple, rules) -> PartitionSpec:
    """A leaf's spec from its logical axes: each mapped by ``rules``, a
    mesh axis used once (a later dim that maps to it stays replicated)."""
    spec, used = [], set()
    for ax in ax_tuple:
        m = rules.get(ax)
        if m is None or m in used:
            spec.append(None)
        else:
            spec.append(m)
            used.add(m)
    return P(*spec)


def param_specs(cfg: ModelConfig, mesh, *, fsdp: bool = False):
    """Tree of PartitionSpecs matching ``model_def`` params."""
    rules = axis_rules(cfg, mesh, fsdp=fsdp)
    specs = tree_map(lambda axes: spec_of(axes, rules), logical_axes(cfg))
    if not cfg.tie_embeddings:
        # untied table: shard d_model, not vocab, so the token gather stays
        # local; under FSDP the vocab dim absorbs the data axis
        specs["embed"] = P("data" if fsdp else None, "model")
    return specs


def opt_specs(cfg: ModelConfig, mesh, pspecs, *, zero: bool = True):
    """ZeRO-1: moments take the param spec + 'data' on the first
    replicated divisible dim.  ``count`` stays replicated."""
    dsize = mesh.shape["data"]

    def zspec(spec, pdef):
        if not zero:
            return spec
        parts = list(spec) + [None] * (len(pdef.shape) - len(spec))
        if "data" in parts:        # already data-sharded (FSDP params)
            return P(*parts)
        for i, (ax, dim) in enumerate(zip(parts, pdef.shape)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                parts[i] = "data"
                break
        return P(*parts)

    mv = tree_map(zspec, pspecs, model_def(cfg))
    return {"m": mv, "v": mv, "count": P()}


def gather_specs(cfg: ModelConfig, mesh):
    """Per-layer compute-time weight specs (the FSDP gather targets): the
    model-only param specs of the stacked subtrees with the leading
    'layer' axis stripped, and the tail's as they are."""
    full = param_specs(cfg, mesh, fsdp=False)
    out = {}
    for key in ("layers", "groups", "enc_layers", "dec_layers"):
        if key in full:
            out[key] = tree_map(lambda s: P(*s[1:]) if len(s) else s,
                                full[key])
    if "tail" in full:
        out["tail"] = full["tail"]
    return out


def _is8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _first_moment_leaf(tree):
    while isinstance(tree, dict) and not _is8(tree):
        tree = next(iter(tree.values()))
    return tree


def opt_specs_for(cfg: ModelConfig, mesh, pspecs, aopt, *, zero: bool = True):
    """Specs matching an optimizer state tree (float32 or 8-bit moments)."""
    if _is8(_first_moment_leaf(aopt["m"])):
        return opt_specs_8bit(cfg, mesh, pspecs, zero=zero)
    return opt_specs(cfg, mesh, pspecs, zero=zero)


def opt_specs_8bit(cfg: ModelConfig, mesh, pspecs, *, zero: bool = True):
    """8-bit moments are {"q": int8 like the param, "scale": float32 (...,
    1)}: q takes the ZeRO'd param spec, scale the same with its last dim
    replicated."""
    base = opt_specs(cfg, mesh, pspecs, zero=zero)

    def expand(spec):
        parts = list(spec)
        return {"q": spec, "scale": P(*parts[:-1], None) if parts else P()}

    mv = tree_map(expand, base["m"])
    return {"m": mv, "v": mv, "count": P()}


def q_specs(moment_specs):
    """The moments' param-shaped specs: the ``q`` spec of each 8-bit
    {"q", "scale"} entry, a float32 moment's spec as it is."""
    if _is8(moment_specs):
        return moment_specs["q"]
    if isinstance(moment_specs, dict):
        return {k: q_specs(v) for k, v in moment_specs.items()}
    return moment_specs


def batch_specs(cfg: ModelConfig, shape: Optional[ShapeConfig], mesh):
    """PartitionSpecs for the input batch tree."""
    b = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    specs = {"tokens": P(b, None), "targets": P(b, None), "mask": P(b, None)}
    if cfg.family == "vlm":
        specs["vision_embeds"] = P(b, None, None)
        specs["position_ids"] = P(None, b, None)
    if cfg.family == "encdec":
        specs["frame_embeds"] = P(b, None, None)
    return specs


def cache_specs(cfg: ModelConfig, mesh, cache_tree):
    """Decode cache: batch over ("pod","data"); the long axis over
    "model" (attention rings' window axis; recurrent and SSM states'
    channels or heads).  Leaves need only ``.shape``."""
    b = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    msize = mesh.shape["model"]
    bshards = math.prod(mesh.shape[a] for a in b)

    def spec_for(name, leaf):
        # rank-agnostic (leading layer dims optional):
        #   (..., B, W, Hkv, dh) attn/cross; (..., B, K-1, C) conv;
        #   (..., B, H, P, N) ssm; (..., B, W_lru) lru h state
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts = [None] * nd

        def set_model(idx):
            if shape[idx] % msize == 0 and shape[idx] >= msize:
                parts[idx] = "model"

        if name in ("k", "v") or name.startswith("cross_"):
            bi = nd - 4
            set_model(nd - 3)                          # window axis
        elif name == "h":
            bi = nd - 2
            set_model(nd - 1)                          # lru width
        elif name == "ssm":
            bi = nd - 4
            set_model(nd - 3)                          # heads
        elif name.startswith("conv"):
            bi = nd - 3
            set_model(nd - 1)                          # channels
        else:
            return P(*parts)
        if shape[bi] % bshards == 0 and shape[bi] >= bshards:
            parts[bi] = b
        return P(*parts)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, str(i)) for i, v in enumerate(node))
        return spec_for(name, node)

    return walk(cache_tree, "")


def named(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# realization on a rank: sharded at rest, gathered on use
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_only(spec) -> PartitionSpec:
    """``spec`` with every entry but the batch axes replicated."""
    keep = []
    for e in spec:
        axes = tuple(a for a in entry_axes(e) if a in BATCH_AXES)
        keep.append(axes or None)
    return P(*keep)


def sharded_dims(spec, ndim: int):
    """[(dim, axes)] of every dim ``spec`` shards."""
    return [(i, entry_axes(e)) for i, e in enumerate(tuple(spec)[:ndim])
            if entry_axes(e)]


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for i, axes in sharded_dims(spec, len(shape)):
        n = math.prod(mesh.shape[a] for a in axes)
        if shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({n} ranks)")
        out[i] = shape[i] // n
    return tuple(out)


def local_slices(shape, spec, comm) -> Tuple[slice, ...]:
    """This rank's slice of a leaf of ``shape`` under ``spec``."""
    loc = local_shape(shape, spec, comm.mesh)
    out = []
    for i, n in enumerate(shape):
        axes = entry_axes(tuple(spec)[i]) if i < len(spec) else ()
        j = comm.index(axes) if axes else 0
        out.append(slice(j * loc[i], (j + 1) * loc[i]))
    return tuple(out)


def shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` (a contiguous copy)."""
    comm = sharding.mesh.comm()
    return t[local_slices(t.shape, sharding.spec, comm)].contiguous()


def spread_dims(spec, ndim: int, mesh):
    """``sharded_dims`` without the dims whose axes hold one rank in all
    (a gather over one rank is the leaf itself)."""
    return [(i, axes) for i, axes in sharded_dims(spec, ndim)
            if math.prod(mesh.shape[a] for a in axes) > 1]


def gather(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full leaf from every rank's part ``t`` (a collective over the
    axes the spec shards; ``t`` itself when it shards none, or only over
    axes of one rank)."""
    comm = sharding.mesh.comm()
    for dim, axes in spread_dims(sharding.spec, t.dim(), sharding.mesh):
        t = comm.all_gather(t, axes, dim)
    return t


def shard_tree(tree, shardings):
    return tree_map(shard, tree, shardings)


def gather_tree(tree, shardings):
    return tree_map(gather, tree, shardings)


class _GatherOnUse(torch.autograd.Function):
    """Forward: the full leaf from the ranks' parts.  Backward: the
    gradient summed over the batch axes of each sharded dim (the ranks of
    those axes saw other rows), then this rank's slice; along the
    ``model`` axis only sliced (its ranks computed the same gradient).
    The JAX step's ``_gather_bwd`` (psum over "data" + local slice)."""

    @staticmethod
    def forward(ctx, w, sharding):
        ctx.sharding = sharding
        return gather(w, sharding)

    @staticmethod
    def backward(ctx, ct):
        sharding = ctx.sharding
        comm = sharding.mesh.comm()
        dims = sharded_dims(sharding.spec, ct.dim())
        loc = local_shape(ct.shape, sharding.spec, sharding.mesh)
        # slice the model-only dims first: the sums then move less
        for dim, axes in sorted(dims, key=lambda d: any(
                a in BATCH_AXES for a in d[1])):
            red = [a for a in axes if a in BATCH_AXES]
            if red:
                ct = comm.all_reduce(ct.contiguous(), red)
            j = comm.index(axes)
            ct = ct.narrow(dim, j * loc[dim], loc[dim])
        return ct.contiguous(), None


def gather_on_use(w: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``gather(w)`` inside the differentiated region (``_GatherOnUse``);
    ``w`` itself when the spec shards nothing, or only over axes of one
    rank (its gradient then lands in ``w``'s own, as without a mesh)."""
    if not spread_dims(sharding.spec, w.dim(), sharding.mesh):
        return w
    return _GatherOnUse.apply(w, sharding)


class RowGroup:
    """The ranks that share a row of a leaf whose last axis is sharded
    over ``axes``: ``amax`` reduces per-row maxima (a tensor (..., 1))
    over them."""

    def __init__(self, comm, axes: Sequence[str]):
        self.comm, self.axes = comm, tuple(axes)

    def amax(self, m: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(m.contiguous(), self.axes, "max")


def row_groups(spec_tree, ndims, mesh):
    """A tree of ``RowGroup`` (None where the spec leaves the last axis
    whole) for leaves of ``ndims`` (a tree of ints) under ``spec_tree``."""
    comm = mesh.comm()

    def one(spec, nd):
        axes = entry_axes(tuple(spec)[nd - 1]) if 0 < nd <= len(spec) else ()
        return RowGroup(comm, axes) if axes else None

    return tree_map(one, spec_tree, ndims)

