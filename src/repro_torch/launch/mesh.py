"""Meshes: ranks in a grid with named axes, and their collectives.

``Mesh`` is the port's counterpart of ``jax.sharding.Mesh``: a
description only — an array of process ranks (one rank drives one card)
and its axis names, with ``.shape`` (axis name -> size, in order),
``.size`` and ``.axis_names``.  Building one touches no device and no
process group, so ``make_production_mesh`` builds the (16, 16) and
(2, 16, 16) meshes anywhere.  ``Mesh.comm()`` realizes it when a step
runs: a ``MeshComm`` creates the ``torch.distributed`` process groups of
the axes a collective names, the first time it names them.

``make_production_mesh`` is the pinned deliverable mesh: a 16x16 pod
(256 chips; axes data x model) or 2x16x16 (512 chips; pod x data x
model), the ``spread_rate = 1`` layout of ``core.layout.Layout``.

Every collective counts its operand bytes on this rank by class, as the
JAX package's HLO parse (``launch/hlo_analysis.py``) classes a
collective's replica group: ``cross_pod`` when its ranks span pods,
``intra_pod`` when they span data rows (chiplet groups) of a pod,
``intra_group`` otherwise; and by op (``all-reduce``, ``all-gather``, the
HLO names).  A group of one rank moves no bytes and counts none.

``Mesh.dry(rank)`` makes the mesh's comm a dry one (the dry run's,
``launch/dryrun.py``): a fixed rank, no process group; each collective
counts its bytes as a real one would and returns a tensor of the result's
shape and type without moving data.  It takes only tensors that hold no
data (fake ones, ``kernels/dry.py``), so a step that reached it
with real tensors raises instead of computing on empty ones.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import dry


class Mesh:
    """``Mesh(devices, axis_names)``: ``devices`` an array of ranks (any
    objects for a description only) shaped by the axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-axis devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self._comm = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank) -> Dict[str, int]:
        """Axis name -> index of ``rank`` in the grid."""
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh once")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group_ranks(self, rank, axes: Sequence[str]) -> List:
        """The ranks that share every coordinate of ``rank`` but those of
        ``axes``, in mixed-radix order over ``axes`` (the first axis
        major): the order in which a dim sharded over ``axes`` holds its
        slices."""
        c = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            cc = dict(c, **dict(zip(axes, idx)))
            out.append(self.devices[tuple(cc[a] for a in self.axis_names)])
        return out

    def classify(self, ranks) -> str:
        """``cross_pod``, ``intra_pod`` or ``intra_group`` for a
        collective over ``ranks`` (``classify_group`` of the JAX package's
        HLO analysis, on this mesh's coordinates)."""
        cs = [self.coords(r) for r in ranks]
        pods = {c.get("pod", 0) for c in cs}
        rows = {(c.get("pod", 0), c.get("data", 0)) for c in cs}
        if len(pods) > 1:
            return "cross_pod"
        if len(rows) > 1:
            return "intra_pod"
        return "intra_group"

    def comm(self) -> "MeshComm":
        """This process's collectives over the mesh (built once)."""
        if self._comm is None:
            self._comm = MeshComm(self)
        return self._comm

    def dry(self, rank=0) -> "MeshComm":
        """Make this mesh's comm a dry one at ``rank`` (see the module
        note) and return it.  Raises when the comm is already built: a
        mesh is dry or real for its whole life."""
        if self._comm is not None:
            raise RuntimeError(f"{self} already has its comm")
        self._comm = MeshComm(self, dry_rank=rank)
        return self._comm

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


def data_axis_size(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class MeshComm:
    """Collectives of this process over ``mesh``'s axes.

    The process's rank is ``torch.distributed``'s when a process group is
    initialized (it must lie in the mesh), else 0 on a one-rank mesh, or
    ``dry_rank`` for a dry comm (``Mesh.dry``).
    ``group(axes)`` creates every group of ``axes`` on first use — each
    process creates the same groups in the same order, as
    ``dist.new_group`` requires — and keeps its own.  Collectives on a
    group of one rank are still issued when a process group exists (a
    world of one on NCCL runs them) and skipped otherwise.  ``bytes``
    sums each collective's operand bytes by class, ``op_bytes`` by op,
    ``n_ops`` counts the collectives that moved bytes."""

    def __init__(self, mesh: Mesh, dry_rank=None):
        self.mesh = mesh
        self.dry = dry_rank is not None
        self.initialized = (not self.dry and dist.is_available()
                            and dist.is_initialized())
        self.rank = dry_rank if self.dry else (
            dist.get_rank() if self.initialized else 0)
        if not self.initialized and not self.dry and mesh.size != 1:
            raise RuntimeError(f"a {mesh.shape} mesh needs an initialized "
                               "torch.distributed process group")
        if self.initialized and dist.get_world_size() < mesh.size:
            raise RuntimeError(f"a {mesh.shape} mesh needs {mesh.size} ranks, "
                               f"the world has {dist.get_world_size()}")
        self.coords = mesh.coords(self.rank)
        self.bytes: Dict[str, float] = {}
        self.op_bytes: Dict[str, float] = {}
        self.n_ops = 0
        self._groups: Dict[Tuple[str, ...], Tuple[list, object]] = {}
        self._classes: Dict[Tuple[str, ...], str] = {}

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.mesh.shape[a] for a in axes]))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's mixed-radix index over ``axes``."""
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + self.coords[a]
        return i

    def group(self, axes: Sequence[str]):
        """(ranks in mixed-radix order over ``axes``, process group) of
        this rank's group along ``axes``."""
        axes = tuple(axes)
        if axes not in self._groups:
            mine = self.mesh.group_ranks(self.rank, axes)
            pg = None
            if self.initialized:
                world = dist.get_world_size()
                others = [a for a in self.mesh.axis_names if a not in axes]
                for idx in itertools.product(
                        *(range(self.mesh.shape[a]) for a in others)):
                    where = dict(zip(others, idx))
                    anchor = self.mesh.devices[tuple(
                        where.get(a, 0) for a in self.mesh.axis_names)]
                    ranks = self.mesh.group_ranks(anchor, axes)
                    if len(ranks) == world:
                        g = dist.group.WORLD
                    else:
                        g = dist.new_group(sorted(int(r) for r in ranks))
                    if sorted(ranks) == sorted(mine):
                        pg = g
            self._groups[axes] = (mine, pg)
            self._classes[axes] = self.mesh.classify(mine) \
                if len(mine) > 1 else None
        return self._groups[axes]

    def _count(self, op, axes, t: torch.Tensor):
        if self.dry and not dry.is_dry(t):
            raise RuntimeError(f"a dry mesh's {op} got a tensor with data "
                               f"on {t.device}: a dry mesh never runs a "
                               "real step")
        cls = self._classes[tuple(axes)]
        if cls is not None:
            n = t.numel() * t.element_size()
            self.bytes[cls] = self.bytes.get(cls, 0.0) + n
            self.op_bytes[op] = self.op_bytes.get(op, 0.0) + n
            self.n_ops += 1

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group along ``axes``, in place."""
        _, pg = self.group(axes)
        if self.initialized or self.dry:
            self._count("all-reduce", axes, t)
        if self.initialized:
            dist.all_reduce(t, op=_OPS[op], group=pg)
        return t

    def all_gather(self, t: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """The group's ``t`` concatenated along ``dim`` in mixed-radix
        order over ``axes`` (a new tensor)."""
        ranks, pg = self.group(axes)
        if self.dry:
            self._count("all-gather", axes, t)
            shape = list(t.shape)
            shape[dim] *= len(ranks)
            return t.new_empty(shape)
        if not self.initialized:
            return t.clone()
        t = t.contiguous()
        self._count("all-gather", axes, t)
        parts = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(parts, t, group=pg)
        # all_gather returns the parts in group-rank order: sorted ranks
        by_rank = dict(zip(sorted(int(r) for r in ranks), parts))
        return torch.cat([by_rank[int(r)] for r in ranks], dim=dim)

    def barrier(self):
        if self.initialized:
            dist.barrier()
