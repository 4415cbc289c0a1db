"""Tensor-parallel compute along a mesh axis, and the global batch's means:
what a rank of the port's counterpart of the JAX package's GSPMD train
step (``launch.steps.make_train_step_spmd``) hands the model code as
``tp=`` (``transformer.loss_fn`` and the functions it calls).

Megatron's scheme.  The residual stream is whole on every rank of the
``model`` axis, and so is its gradient.  A column-parallel product (the
attention's ``wq`` / ``wk`` / ``wv``, the cross-attention's on the
encoder's output, the MLP's and the experts' ``wi``, the SSD's ``wz`` /
``wx`` / ``wdt`` / ``wB`` / ``wC``, the RG-LRU's ``w_gate`` / ``w_in``,
the output head) takes its input through ``copy`` — the identity
forward, the sum of the ranks' input gradients over the axis backward —
and computes the rank's slice of the heads, ``ff``, channels or
vocabulary.  A row-parallel product (``wo``, ``out_proj``, ``w_out``)
sums its partial outputs over the axis in ``reduce`` — the identity
backward, since what follows is computed the same on every rank.  A
weight the specs leave whole is computed with the same on every rank and
gets the whole gradient there, with two exceptions: a replicated ``wk``
/ ``wv`` of which a rank reads only the kv heads of its query heads (its
gradient is summed over the axis once a step, by the step), and an MoE
layer's gates, whose gradient is summed through ``copy`` (the experts'
outputs are the rank's partial sums).

Two blocks read a whole activation from the ranks' slices, each rank for
its own shards, so each rank's gradient of the whole is partial: the
RG-LRU's gates read the whole conv output (``w_a`` / ``w_x`` are column
slices over all of it), and an SSD rank's heads read their group's whole
B and C where the specs cut ``ssd_bc``.  ``gather_summed`` gathers them;
its backward sums over the axis, then slices (``gather``'s only slices:
right where every rank computes the same with the whole, as after the
untied embedding's lookup).  The SSD's gated RMS norm runs over all of
``d_inner``: its mean square is the ranks' partial sums of squares
summed by ``psum``, whose backward sums too, since each rank uses the
sum on its own channels.

The batch axes.  The step cuts the global batch over ("pod", "data"), as
GSPMD shards ``P(("pod", "data"), None)``, and GSPMD computes each
mean over the global batch: the loss's token count and an MoE block's
load-balance means are summed over ``batch_axes`` here (``batch_sum``,
``batch_mean``), so that the ranks' losses add up to the global one.

The serving steps (``steps.make_prefill_spmd``, ``make_serve_step_spmd``)
hand the same object, built with ``means=False``, to the forward and the
token step, which run without gradients: the MoE balance terms they
discard are then the rank's own, with no collective.  There each rank
also needs every kv head of a layer where it computed its own
(``all_kv_heads``) and the max of a quantity over the axis (``pmax``).

Only the collectives of the comm (``launch.mesh.MeshComm``, duck-typed:
``size``, ``index``, ``all_reduce``, ``all_gather``) are used, so a dry
comm traces the same program on tensors without data.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch


class _Copy(torch.autograd.Function):
    """Forward the identity; backward the gradient summed over ``axes``."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.comm.all_reduce(g, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    """Forward the sum over ``axes``; backward the identity."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """Forward the ranks' parts concatenated along ``dim``; backward this
    rank's slice of the gradient (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.j = comm.index(axes)
        return comm.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.j * ctx.n, ctx.n).contiguous(), \
            None, None, None


class _GatherSummed(torch.autograd.Function):
    """Forward the ranks' parts concatenated along ``dim``; backward the
    gradient summed over ``axes``, then this rank's slice of it (a
    reduce-scatter): each rank holds only its part of the gathered
    tensor's gradient, from the compute it did with the whole."""

    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes = comm, axes
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.j = comm.index(axes)
        return comm.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.comm.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                ctx.axes)
        return g.narrow(ctx.dim, ctx.j * ctx.n, ctx.n).contiguous(), \
            None, None, None


class _Sum(torch.autograd.Function):
    """Forward the sum over ``axes``; backward the gradient summed over
    them too: each rank uses the sum on its own part, so its gradient of
    the sum is partial."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axes)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.comm.all_reduce(g, ctx.axes), None, None


class _LogSumExp(torch.autograd.Function):
    """The log-sum-exp over the last axis of logits cut over ``axes``:
    ``torch.logsumexp``'s operations (the max, the sum of exponentials
    shifted by it, its log plus the max) with the max and the sum reduced
    over the axes, and its backward (``g · exp(logits - lse)``), so that
    on one rank it is ``torch.logsumexp`` bit for bit."""

    @staticmethod
    def forward(ctx, logits, comm, axes):
        m = comm.all_reduce(logits.amax(dim=-1), axes, "max")
        s = comm.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1),
                            axes)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - lse[..., None]), None, None


class TensorParallel:
    """``TensorParallel(comm, split, batch_axes=(), axis="model",
    means=True)``: the ranks of ``comm``'s mesh along ``axis`` split the
    products of the logical axes in ``split`` (``sharding.axis_rules``
    names: "heads", "kv_heads", "ff", "vocab", "lru", "ssd_inner",
    "ssd_bc", "ssd_heads"); ``batch_axes`` are the mesh axes the global
    batch is cut over; ``means=False``: ``batch_mean`` is the rank's own
    (the serving steps, which discard it)."""

    def __init__(self, comm, split: Iterable[str],
                 batch_axes: Sequence[str] = (), axis: str = "model",
                 means: bool = True):
        self.comm = comm
        self.means = means
        self.axes = (axis,)
        self.size = comm.size(self.axes)
        self.rank = comm.index(self.axes)
        self.split = frozenset(split)
        self.batch_axes = tuple(batch_axes)
        self.batch_shards = comm.size(self.batch_axes)

    def splits(self, logical: str) -> bool:
        return logical in self.split

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.comm, self.axes)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.comm, self.axes)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' parts of ``x`` along ``dim``, for compute that every
        rank does the same with the whole (its gradient is whole on every
        rank: the backward only slices)."""
        return _Gather.apply(x, self.comm, self.axes, dim % x.dim())

    def gather_summed(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' parts of ``x`` along ``dim``, for compute that each
        rank does with the whole on its own shards (its gradient is
        partial: the backward sums it over the axis, then slices)."""
        return _GatherSummed.apply(x, self.comm, self.axes, dim % x.dim())

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial ``x`` over the axis, summed both
        ways (``_Sum``)."""
        return _Sum.apply(x, self.comm, self.axes)

    def logsumexp(self, logits: torch.Tensor) -> torch.Tensor:
        """The log-sum-exp of the whole vocabulary's logits from the
        rank's slice (``_LogSumExp``)."""
        return _LogSumExp.apply(logits, self.comm, self.axes)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the batch axes (no gradient)."""
        return self.comm.all_reduce(
            x.detach().clone(memory_format=torch.contiguous_format),
            self.batch_axes)

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the batch axes of a per-rank mean over equal
        shares; its gradient reaches each rank's share.  ``x`` itself
        without ``means``."""
        if not self.means:
            return x
        return _Reduce.apply(x, self.comm, self.batch_axes) \
            / self.batch_shards

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum over the axis (no gradient)."""
        return self.comm.all_reduce(
            x.detach().clone(memory_format=torch.contiguous_format),
            self.axes, "max")

    def heads(self, n_heads: int) -> slice:
        """This rank's slice of ``n_heads`` heads cut over the axis."""
        hl = n_heads // self.size
        return slice(self.rank * hl, (self.rank + 1) * hl)

    def groups(self, n_heads: int, n_groups: int) -> slice:
        """The groups that this rank's heads read, of ``n_heads`` heads in
        ``n_groups`` groups (head h reads group h // G): the rank's heads
        cover whole groups, or lie in one."""
        G = n_heads // n_groups
        hl = n_heads // self.size
        h0 = self.rank * hl
        if hl % G and G % hl:
            raise ValueError(f"{hl} heads a rank straddle groups of {G}")
        return slice(h0 // G, max(h0 + hl, h0 + G) // G)

    def kv_heads(self, w: torch.Tensor, n_heads: int,
                 n_kv_heads: int) -> torch.Tensor:
        """Of a replicated ``wk`` / ``wv`` (D, Hkv, dh), the kv heads that
        this rank's query heads read (``groups``)."""
        return w[:, self.groups(n_heads, n_kv_heads)]

    def all_kv_heads(self, k: torch.Tensor, n_heads: int,
                     n_kv_heads: int) -> torch.Tensor:
        """Every kv head of keys or values (B, S, ·, dh) of which this rank
        computed its own: its slice where the specs cut the kv heads, else
        the kv heads of its query heads (``groups``), which ranks of one
        group share.  Gathered over the axis (no gradient) and, where
        ranks share a kv head, each head taken from the first rank that
        holds it."""
        every = self.comm.all_gather(k.contiguous(), self.axes, 2)
        G, hl = n_heads // n_kv_heads, n_heads // self.size
        if self.splits("kv_heads") or hl >= G:   # every rank its own
            return every
        return every[:, :, ::G // hl]     # G // hl ranks read one kv head
